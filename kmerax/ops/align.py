"""Banded global alignment + seed-extend (SURVEY.md §2 #14; DESIGN.md §10).

The reference's SIMD banded DP becomes a row-iterated band in diagonal
coordinates, with the within-row gap dependency solved by the max-plus
prefix-scan identity (linear gap g = -4):

    S[i][j] = max_{j'<=j} ( M[i][j'] - 4*(j-j') )
            = cummax_j ( M[i][j] + 4*j ) - 4*j

so each DP row is a handful of vectorized ops + one cumulative max over the
band — no sequential inner loop. Scores are bit-exact vs oracle.align
(match +2 / mismatch -3 / gap -4, -inf outside the band).

This XLA formulation advances the whole batch one DP row per loop step and
is the reference the GPU kernel (ops.pallas_align) is held to; `band_scores`
picks the kernel on the GPU and this path everywhere else.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MATCH, MISMATCH, GAP = 2, -3, -4
NEG_INF = -(1 << 30)


def banded_align_scores(query, target, qlen, tlen, band: int):
    """Batched banded global alignment scores, bit-exact vs oracle.

    Args:
      query: (B, n) int32 base codes (>=4 never matches).
      target: (B, m) int32.
      qlen / tlen: (B,) int32 true lengths (qlen <= n, tlen <= m).
      band: static half-width; |i-j| > band cells are unreachable.
    Returns (B,) int32 scores (oracle NEG_INF when no in-band path exists).
    """
    B, n = query.shape
    m = target.shape[1]
    W = 2 * band + 1
    assert W <= 128, "band must fit one vector register row"
    d_iota = jnp.arange(W, dtype=jnp.int32)           # d = j - i + band

    tl = tlen[:, None]
    # row 0: S[0][j] = GAP*j for 0 <= j <= min(band, tlen), else -inf
    j0 = (d_iota - band)[None, :]
    row0 = jnp.where((j0 >= 0) & (j0 <= tl), GAP * j0, NEG_INF)
    row0 = jnp.broadcast_to(row0, (B, W)).astype(jnp.int32)

    # tpad[:, i + d] == target[:, j-1] for j = i + d - band
    # (left pad band+1; right pad so index n + 2*band stays in range)
    rpad = max(0, n + 2 * band + 1 - (band + 1 + m))
    tpad = jnp.concatenate(
        [jnp.full((B, band + 1), 4, jnp.int32), target,
         jnp.full((B, rpad), 4, jnp.int32)], axis=1)

    def step(i, carry):
        prev, rows = carry                             # prev: (B, W)
        tslc = jax.lax.dynamic_slice_in_dim(tpad, i, W, axis=1)
        qi = jax.lax.dynamic_slice_in_dim(query, i - 1, 1, axis=1)  # (B,1)
        sub = jnp.where((tslc == qi) & (qi < 4), MATCH, MISMATCH)

        diag = prev + sub                              # S[i-1][j-1]
        up = jnp.concatenate(
            [prev[:, 1:], jnp.full((B, 1), NEG_INF, jnp.int32)],
            axis=1) + GAP                              # S[i-1][j]
        j = i + d_iota[None, :] - band
        valid = (j >= 1) & (j <= tl)
        Mv = jnp.where(valid, jnp.maximum(diag, up), NEG_INF)
        col0 = jnp.where((j == 0) & (i <= band), GAP * i, NEG_INF)
        f = jnp.maximum(Mv, col0) - GAP * d_iota[None, :]
        row = jax.lax.cummax(f, axis=1) + GAP * d_iota[None, :]
        row = jnp.where(valid | ((j == 0) & (i <= band)), row, NEG_INF)
        rows = jax.lax.dynamic_update_slice_in_dim(
            rows, row[:, None, :], i, axis=1)
        return row, rows

    rows0 = jnp.full((B, n + 1, W), NEG_INF, jnp.int32).at[:, 0, :].set(row0)
    _, rows = jax.lax.fori_loop(1, n + 1, step, (row0, rows0))

    # final cell: row qlen, d = tlen - qlen + band
    bidx = jnp.arange(B)
    dfin = jnp.clip(tlen - qlen + band, 0, W - 1)
    score = rows[bidx, qlen, dfin]
    return jnp.where(jnp.abs(tlen - qlen) <= band, score, NEG_INF)


def band_scores(query, target, qlen, tlen, band: int):
    """Banded scores on this backend: the Pallas kernel (ops.pallas_align)
    on the GPU, the XLA path above elsewhere. Both are bit-exact vs
    oracle.align."""
    if jax.default_backend() == "gpu":
        from kmerax.ops.pallas_align import banded_align_scores_pallas

        return banded_align_scores_pallas(query, target, qlen, tlen, band)
    return banded_align_scores(query, target, qlen, tlen, band)


def build_contig_index(contig_bases: list, k: int, chunk: int = 1 << 20):
    """Device-extracted, host-deduped read-to-contig index (DESIGN.md §10b).

    contig_bases: list of uint8 arrays. Returns (cat (N,) int8 numpy,
    uniq (M, W) uint32 device rows sorted, payload (M,) int32 device =
    pos << 1 | fwd, smallest pos per canonical k-mer). Extraction runs on
    device in fixed overlapping chunks (one compile); the dedup is the
    host radix merge (cheap, index build is once per run).
    """
    import numpy as np

    from kmerax.core.codec import canonical_words
    from kmerax.core.kmers import extract_kmers
    from kmerax.spectrum.exact import SENTINEL_WORD

    w = (k + 15) // 16
    sep = np.full(k - 1, 4, np.uint8)
    parts = []
    for i, c in enumerate(contig_bases):
        if i:
            parts.append(sep)
        parts.append(np.asarray(c, dtype=np.uint8))
    cat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    N = len(cat)
    assert N < (1 << 30), "contig index positions must fit int32 payloads"
    if N < k:
        return cat, jnp.full((1, w), SENTINEL_WORD, jnp.uint32), \
            jnp.zeros(1, jnp.int32)

    CL = chunk + k - 1

    @jax.jit
    def ext(b):
        words, valid = extract_kmers(b[None], k)
        canon, fwd = canonical_words(words, k)
        return canon[0], fwd[0], valid[0]

    rows_l, pay_l = [], []
    for s0 in range(0, N - k + 1, chunk):
        piece = cat[s0:s0 + CL].astype(np.int32)
        nw = min(chunk, (N - k + 1) - s0)
        if len(piece) < CL:
            piece = np.concatenate(
                [piece, np.full(CL - len(piece), 4, np.int32)])
        canon, fwd, valid = ext(jnp.asarray(piece))
        canon = np.asarray(canon)[:nw]
        fwd = np.asarray(fwd)[:nw]
        valid = np.asarray(valid)[:nw]
        pos = np.arange(s0, s0 + nw, dtype=np.int64)
        rows_l.append(canon[valid])
        pay_l.append((pos[valid] << 1) | fwd[valid])
    rows = np.concatenate(rows_l, axis=0)
    pay = np.concatenate(pay_l, axis=0)
    if len(rows) == 0:
        return cat, jnp.full((1, w), SENTINEL_WORD, jnp.uint32), \
            jnp.zeros(1, jnp.int32)
    # sort by (kmer, payload); first occurrence per kmer = smallest pos
    order = np.lexsort((pay,) + tuple(rows[:, i] for i in range(w)))
    rows, pay = rows[order], pay[order]
    first = np.concatenate([[True], np.any(rows[1:] != rows[:-1], axis=1)])
    return cat, jnp.asarray(rows[first]), \
        jnp.asarray(pay[first].astype(np.int32))


def _extend_and_score(cat_dev, bases, lengths, is_fwd, off, payload, found,
                      k: int, band: int):
    """Seed -> oriented window -> banded DP; the shared tail of the
    validate_batch variants. Returns (found, strand, pos, score)."""
    B, Lmax = bases.shape
    rfwd = jnp.take_along_axis(is_fwd, off[:, None], axis=1)[:, 0]
    cfwd = (payload & 1) == 1
    pos = payload >> 1
    strand = (found & (rfwd != cfwd)).astype(jnp.int32)

    irev = lengths[:, None] - 1 - jnp.arange(Lmax, dtype=jnp.int32)[None, :]
    rcb = bases[jnp.arange(B)[:, None], jnp.clip(irev, 0, Lmax - 1)]
    rcb = jnp.where((irev >= 0) & (rcb < 4), 3 - rcb, 4)
    Q = jnp.where((strand == 1)[:, None], rcb, bases)
    jq = jnp.where(strand == 1, lengths - k - off, off)
    start = pos - jq

    M = cat_dev.shape[0]
    tidx = start[:, None] + jnp.arange(Lmax, dtype=jnp.int32)[None, :]
    oob = (tidx < 0) | (tidx >= M) | ~found[:, None]
    T = jnp.where(oob, 4,
                  cat_dev[jnp.clip(tidx, 0, M - 1)].astype(jnp.int32))
    score = band_scores(Q, T, lengths, lengths, band)
    score = jnp.where(found & (lengths >= k), score, NEG_INF)
    found = found & (lengths >= k)
    return found, jnp.where(found, strand, 0), \
        jnp.where(found, pos, -1), score


def validate_batch(cat_dev, index_uniq, index_pay, bases, lengths,
                   k: int, band: int, index_pref=None, index_hash=None):
    """Batched seed-extend read validation (DESIGN.md §10b), bit-exact vs
    oracle.validate_read. Returns (found (B,), strand (B,), pos (B,),
    score (B,) — NEG_INF when unaligned). `index_pref` = optional
    (ptable, steps) from spectrum.exact.prefix_table for the fast seed
    search; `index_hash` = optional (tab, n_slots, attempt) cuckoo index
    from ops.seed_hash.build_seed_hash (two gathers per probe, full
    position width). All three paths return identical results; the
    streaming stages use validate_batch_phased (faster still)."""
    from kmerax.core.codec import canonical_words
    from kmerax.core.kmers import extract_kmers

    bases = bases.astype(jnp.int32)
    words, valid = extract_kmers(bases, k)
    canon, is_fwd = canonical_words(words, k)
    off, payload, found = seed_positions(canon, valid, index_uniq, index_pay,
                                         pref=index_pref, shash=index_hash)
    return _extend_and_score(cat_dev, bases, lengths, is_fwd, off, payload,
                             found, k, band)


def validate_batch_phased(cat_dev, index_hash, bases, lengths,
                          k: int, band: int):
    """validate_batch through the two-phase early-exit seed search
    (ops.seed_hash.probe_first_hit — the fast streaming path).

    Returns (found, strand, pos, score, ok). `ok` False (adversarial
    input: >B/4 reads unresolved in the seed prefix) means the batch must
    be REPLAYED through validate_batch(..., index_hash=...) — the driver
    replay idiom; see run_align. With ok True, results are bit-identical
    to validate_batch."""
    from kmerax.core.codec import canonical_words
    from kmerax.core.kmers import extract_kmers
    from kmerax.ops.seed_hash import probe_first_hit

    tab, n_slots, attempt = index_hash
    bases = bases.astype(jnp.int32)
    words, valid = extract_kmers(bases, k)
    canon, is_fwd = canonical_words(words, k)
    off, payload, found, ok = probe_first_hit(tab, n_slots, attempt,
                                              canon, valid)
    out = _extend_and_score(cat_dev, bases, lengths, is_fwd, off, payload,
                            found, k, band)
    return (*out, ok)


def seed_positions(read_canon, read_valid, index_uniq, index_pos,
                   window: int = 8, pref=None, shash=None):
    """First-seed lookup: for each read, the first valid k-mer with an exact
    hit in the target k-mer index (SURVEY.md §3.3 "seed-extend").

    read_canon: (B, nk, W) canonical k-mer words; read_valid: (B, nk).
    index_uniq: (M, W) sorted canonical target k-mers (sentinel padded);
    index_pos: (M,) int32 payload (e.g. target_id << 20 | position).
    Returns (read_offset (B,), payload (B,), found (B,)).

    Two accelerations of the plain binary search, both returning identical
    results:
      * `pref` = (ptable, steps) from spectrum.exact.prefix_table — a
        first-level bucket head start (log2(M) -> a few gather steps);
      * `shash` = (tab, n_slots, attempt) from ops.seed_hash — a cuckoo
        table making every probe exactly TWO independent row gathers.
        When given, index_uniq/index_pos are unused.
    """
    del window
    if shash is not None:
        from kmerax.ops.seed_hash import probe_first_hit_full

        tab, n_slots, attempt = shash
        return probe_first_hit_full(tab, n_slots, attempt, read_canon,
                                    read_valid)
    from kmerax.spectrum.exact import searchsorted_words, \
        searchsorted_words_pref

    if pref is None:
        idx, found = searchsorted_words(index_uniq, read_canon)
    else:
        idx, found = searchsorted_words_pref(index_uniq, read_canon,
                                             pref[0], pref[1])
    found = found & read_valid
    first = jnp.argmax(found, axis=1).astype(jnp.int32)
    any_hit = jnp.any(found, axis=1)
    hit_idx = jnp.take_along_axis(idx, first[:, None], axis=1)[:, 0]
    payload = jnp.where(any_hit, index_pos[hit_idx], -1)
    return first, payload, any_hit
