"""Exact cuckoo-hash k-mer index for the align seed search (SURVEY.md §2
#14; round-4 VERDICT Missing #1).

The sorted-array seed search needs ~4 dependent gather rounds per query
even with the prefix-table head start. A cuckoo table makes every lookup
EXACTLY TWO independent row gathers:

  slot1 = h1(kmer) in table half A, slot2 = h2(kmer) in half B;
  every key provably lives in one of its two slots (build-time guarantee),
  so  found = match(slot1) | match(slot2)  with no probe chains, no
  data-dependent control flow, and both gathers issued in parallel.

Rows are (W key words + 1 payload word) contiguous uint32, so one gather
fetches key and payload together. Empty slots hold the all-ones SENTINEL,
which is not a valid canonical k-mer (bits above 2k would be set) — misses
are exact, not probabilistic.

The build is a host-side vectorized random-walk cuckoo (first-writer-wins
claims + eviction, alternating halves); it retries with fresh hash seeds
on non-convergence (load factor 0.4 converges in a few rounds whp).
Results are bit-identical to spectrum.exact.searchsorted_words over the
same index (tests/unit/test_seed_hash.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from kmerax.core.hash import HASH_SEED_1, HASH_SEED_2, kmer_hash

_GOLD = 0x9E3779B9  # per-attempt seed stride (any odd constant)


def _seeds(attempt: int) -> tuple[int, int]:
    return ((HASH_SEED_1 + _GOLD * attempt) & 0xFFFFFFFF,
            (HASH_SEED_2 + _GOLD * attempt) & 0xFFFFFFFF)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    """numpy twin of core.hash.mix32 (parity-tested)."""
    x = x.astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def kmer_hash_np(words: np.ndarray, seed: int) -> np.ndarray:
    """numpy twin of core.hash.kmer_hash: (..., W) uint32 -> (...) uint32."""
    h = _mix32_np(np.full(words.shape[:-1], seed & 0xFFFFFFFF, np.uint32))
    for i in range(words.shape[-1]):
        h = _mix32_np(h ^ words[..., i])
    return h


class SeedHash(NamedTuple):
    """Built index: `tab` (2S, W+1) uint32 rows (key words + payload);
    `n_slots` = S (per-half, static); `attempt` = hash-seed variant used
    (static). tab rides as a jit ARGUMENT; the ints are compile-time."""

    tab: jnp.ndarray
    n_slots: int
    attempt: int


def build_seed_hash(uniq, pay, *, max_load: float = 0.4,
                    max_iters: int = 500, max_attempts: int = 8) -> SeedHash:
    """Host-side cuckoo build over (M, W) uint32 keys + (M,) int32 payloads.

    Deterministic: the claim order is a seeded shuffle per attempt, so the
    same inputs always build the same table.
    """
    rows = np.ascontiguousarray(np.asarray(uniq), dtype=np.uint32)
    payload = np.asarray(pay).astype(np.uint32)
    M, W = rows.shape
    # drop sentinel padding rows if the caller passed a padded index
    real = ~np.all(rows == np.uint32(0xFFFFFFFF), axis=1)
    if not real.all():
        rows, payload = rows[real], payload[real]
        M = len(rows)
    S = 1 << max(4, int(np.ceil(M / max_load / 2)).bit_length())

    for attempt in range(max_attempts):
        s1, s2 = _seeds(attempt)
        h1 = (kmer_hash_np(rows, s1) & np.uint32(S - 1)).astype(np.int64)
        h2 = (kmer_hash_np(rows, s2) & np.uint32(S - 1)).astype(np.int64) + S
        occupant = np.full(2 * S, -1, np.int64)
        slot_of = np.full(M, -1, np.int64)
        side = np.zeros(M, np.uint8)
        pending = np.arange(M)
        rng = np.random.default_rng(attempt)
        for _ in range(max_iters):
            if len(pending) == 0:
                break
            # symmetry-break: claim order is randomized (seeded)
            pending = rng.permutation(pending)
            slots = np.where(side[pending] == 0, h1[pending], h2[pending])
            occupant[slots] = pending           # last writer wins per slot
            won = occupant[slots] == pending
            winners = pending[won]
            slot_of[winners] = slots[won]
            placed = np.nonzero(slot_of >= 0)[0]
            evicted = placed[occupant[slot_of[placed]] != placed]
            slot_of[evicted] = -1
            losers = pending[~won]
            side[evicted] ^= 1
            side[losers] ^= 1
            pending = np.concatenate([losers, evicted])
        if len(pending) == 0:
            tab = np.full((2 * S, W + 1), 0xFFFFFFFF, np.uint32)
            occ = occupant >= 0
            items = occupant[occ]
            tab[occ, :W] = rows[items]
            tab[occ, W] = payload[items]
            return SeedHash(jnp.asarray(tab), S, attempt)
    raise RuntimeError(
        f"cuckoo build failed after {max_attempts} seed attempts "
        f"(M={M}, S={S})")


def _select_first(pay_all, fnd):
    first = jnp.argmax(fnd, axis=1).astype(jnp.int32)
    any_hit = jnp.any(fnd, axis=1)
    payload = jnp.where(
        any_hit,
        jnp.take_along_axis(pay_all, first[:, None], axis=1)[:, 0], -1)
    return first, payload, any_hit


def probe_first_hit_full(tab, n_slots: int, attempt: int,
                         read_canon, read_valid):
    """Exact first-hit seed search probing EVERY position (the replay step
    for overflowed phased batches). Returns (first, payload, found)."""
    pay_all, fnd = probe_seed_hash(tab, n_slots, attempt, read_canon)
    return _select_first(pay_all, fnd & read_valid)


def probe_first_hit(tab: jnp.ndarray, n_slots: int, attempt: int,
                    read_canon: jnp.ndarray, read_valid: jnp.ndarray,
                    prefix: int = 24):
    """First-hit seed search with a two-phase early-exit.

    Phase A probes only the first `prefix` k-mer positions of every read —
    at sequencing error rates most reads resolve there (a read is
    unresolved only when errors cover ALL prefix windows). Phase B gathers
    the unresolved reads into a B/4-capacity compacted buffer and probes
    their remaining positions. The fallback is a driver-side replay rather
    than an in-graph lax.cond, so the compiled step never carries the
    full-width branch.

    Returns (first_offset (B,), payload (B,), found (B,), ok bool scalar).
    `ok` is False when more than B/4 reads were unresolved (adversarial
    input) — results are then INCOMPLETE and the caller must replay the
    batch through probe_first_hit_full (the same replay idiom as the count
    stage's route overflow, SURVEY.md §7 bounded recirculation). When ok
    is True, results are bit-identical to the full-width probe
    (tests/unit/test_seed_hash.py).
    """
    B, nk, W = read_canon.shape
    PA = min(prefix, nk)
    cap = max(16, B // 4)

    if PA >= nk or cap >= B:
        first, payload, found = probe_first_hit_full(
            tab, n_slots, attempt, read_canon, read_valid)
        return first, payload, found, jnp.asarray(True)

    pay_a, fnd_a = probe_seed_hash(tab, n_slots, attempt,
                                   read_canon[:, :PA])
    first_a, pay_sel_a, any_a = _select_first(pay_a,
                                              fnd_a & read_valid[:, :PA])

    # phase B can only help reads that still have valid positions PAST
    # the prefix — rows without any (batch padding, short reads whose
    # windows all sit inside the prefix, all-invalid reads) are final
    # after phase A and must not consume phase-B capacity or trip the
    # replay flag (their result already matches the full-width probe:
    # found=False, first=0, payload=-1)
    unres = ~any_a & jnp.any(read_valid[:, PA:], axis=1)
    n_un = jnp.sum(unres.astype(jnp.int32))
    (ridx,) = jnp.nonzero(unres, size=cap, fill_value=0)
    # nonzero packs real indices first: rows >= n_un are fill duplicates
    # of index 0 (which may itself be a live unresolved read) — mask by
    # POSITION, not by unres[ridx]
    live = jnp.arange(cap, dtype=jnp.int32) < n_un

    sub = read_canon[ridx][:, PA:]
    subv = read_valid[ridx][:, PA:] & live[:, None]
    pay_b, fnd_b = probe_seed_hash(tab, n_slots, attempt, sub)
    first_b, pay_sel_b, any_b = _select_first(pay_b, fnd_b & subv)
    # scatter back: ridx holds each unresolved read at most once and
    # fill rows are masked to zero contributions, so .add is exact
    scat = lambda v, d: jnp.zeros(B, d).at[ridx].add(
        jnp.where(live, v.astype(d), jnp.zeros((), d)))
    s_any = scat(any_b, jnp.int32) > 0
    s_first = scat(jnp.where(any_b, first_b + PA, 0), jnp.int32)
    s_pay = scat(jnp.where(any_b, pay_sel_b, 0), jnp.int32)
    found = any_a | s_any
    first = jnp.where(any_a, first_a, jnp.where(s_any, s_first, 0))
    payload = jnp.where(any_a, pay_sel_a, jnp.where(s_any, s_pay, -1))
    return first, payload, found, n_un <= cap


def probe_seed_hash(tab: jnp.ndarray, n_slots: int, attempt: int,
                    query_words: jnp.ndarray):
    """(payload int32, found bool) for (..., W) uint32 queries: exactly two
    independent row gathers. Bit-identical found/payload semantics to
    searchsorted_words + index_pos[idx]."""
    W = query_words.shape[-1]
    s1, s2 = _seeds(attempt)
    i1 = (kmer_hash(query_words, s1)
          & jnp.uint32(n_slots - 1)).astype(jnp.int32)
    i2 = (kmer_hash(query_words, s2)
          & jnp.uint32(n_slots - 1)).astype(jnp.int32) + n_slots
    r1 = tab[i1]                                 # (..., W+1)
    r2 = tab[i2]
    m1 = jnp.all(r1[..., :W] == query_words, axis=-1)
    m2 = jnp.all(r2[..., :W] == query_words, axis=-1)
    payload = jnp.where(m1, r1[..., W], r2[..., W]).astype(jnp.int32)
    found = m1 | m2
    return jnp.where(found, payload, -1), found
