"""Exact k-mer spectrum: sort + segment-sum counting (SURVEY.md §2 #9).

The reference's k-mer hash table becomes a *sorted* device array of unique
canonical k-mers + counts: batches are lax.sort-ed (lexicographic over words,
most-significant first), deduped with segment sums, and merged by re-sorting
— every step maps onto XLA's fast parallel sort, no pointer chasing.
Lookups are vectorized binary searches (log2 N gathers).

Invalid/padding lanes use an all-ones SENTINEL row, which is not a valid
canonical k-mer (bits above 2k would be set) and sorts after every real one.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

SENTINEL_WORD = 0xFFFFFFFF


def sentinel_rows(n: int, w: int) -> jnp.ndarray:
    # jit: materialize on device (a staged host constant pays an H2D on
    # first use — see bloom.make_table)
    return jax.jit(
        lambda: jnp.full((n, w), SENTINEL_WORD, dtype=jnp.uint32))()


def mask_invalid(words: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Replace invalid rows with the sentinel so they sort to the end."""
    return jnp.where(valid[..., None], words,
                     jnp.uint32(SENTINEL_WORD))


def is_sentinel(words: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(words == jnp.uint32(SENTINEL_WORD), axis=-1)


def sort_kmers(words: jnp.ndarray, *payloads):
    """Sort (N, W) k-mer rows in big-integer order, carrying payloads along."""
    w = words.shape[-1]
    keys = [words[:, i] for i in range(w - 1, -1, -1)]  # MSW first
    ops = keys + list(payloads)
    out = jax.lax.sort(ops, dimension=0, is_stable=True, num_keys=w)
    sorted_words = jnp.stack(out[:w][::-1], axis=-1)
    return (sorted_words, *out[w:]) if payloads else sorted_words


def unique_counts(sorted_words: jnp.ndarray,
                  weights: jnp.ndarray | None = None):
    """Dedup a SORTED row array.

    Returns (unique (N,W) sentinel-padded & front-compacted, counts (N,)
    int32, n_unique int32 scalar). `weights` defaults to ones (plain
    counting); pass counts when merging pre-counted spectra.
    """
    n, w = sorted_words.shape
    if weights is None:
        weights = jnp.ones(n, dtype=jnp.int32)
    real = ~is_sentinel(sorted_words)
    weights = weights * real.astype(jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones(1, dtype=bool),
         jnp.any(sorted_words[1:] != sorted_words[:-1], axis=-1)])
    seg_id = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    counts = jax.ops.segment_sum(weights, seg_id, num_segments=n)
    tgt = jnp.where(is_start & real, seg_id, n)  # dropped when masked
    uniq = sentinel_rows(n, w).at[tgt].set(sorted_words, mode="drop")
    n_unique = jnp.sum((is_start & real).astype(jnp.int32))
    return uniq, counts, n_unique


def merge_sorted(a_words, a_counts, b_words, b_counts):
    """Merge two deduped sorted spectra (sentinel padding allowed) into one.

    Output capacity = len(a) + len(b); same (words, counts, n_unique) form.
    """
    words = jnp.concatenate([a_words, b_words], axis=0)
    counts = jnp.concatenate([a_counts, b_counts], axis=0)
    sw, sc = sort_kmers(words, counts)
    return unique_counts(sw, sc)


def np_merge_counted(rows, weights):
    """Host-side sort+dedup of (N, W) uint32 k-mer rows with int64 weights.

    Returns (uniq (M, W) uint32 in DESIGN.md §6 global order, counts (M,)
    int64). Sentinel rows must be filtered by the caller. Used by the
    streaming count flush and the sharded gather.
    k <= 31 rows (W=2) take a packed-uint64 radix-sort fast path.
    """
    import numpy as np

    rows = np.ascontiguousarray(rows)
    weights = np.asarray(weights, dtype=np.int64)
    n, w = rows.shape
    if n == 0:
        return rows.reshape(0, w), weights[:0]
    if w == 2:
        packed = (rows[:, 1].astype(np.uint64) << np.uint64(32)) \
            | rows[:, 0].astype(np.uint64)
        order = np.argsort(packed, kind="stable")
        sp = packed[order]
        is_start = np.concatenate([[True], sp[1:] != sp[:-1]])
        srows = rows[order]
    else:
        order = np.lexsort(tuple(rows[:, i] for i in range(w)))
        srows = rows[order]
        is_start = np.concatenate(
            [[True], np.any(srows[1:] != srows[:-1], axis=1)])
    sw = weights[order]
    out = np.add.reduceat(sw, np.nonzero(is_start)[0])
    return srows[is_start], out


def searchsorted_words(uniq_words: jnp.ndarray, query_words: jnp.ndarray):
    """Vectorized binary search: (..., W) queries -> (idx, found).

    idx is the row of the match (clipped lower-bound otherwise). Sentinel
    padding rows compare greater than every real k-mer, so padding is inert.
    """
    from kmerax.core.codec import words_less

    m = uniq_words.shape[0]
    steps = max(1, (m - 1).bit_length())
    lo = jnp.zeros(query_words.shape[:-1], dtype=jnp.int32)
    hi = jnp.full(query_words.shape[:-1], m, dtype=jnp.int32)  # exclusive
    for _ in range(steps):
        mid = (lo + hi) // 2
        mid_rows = uniq_words[jnp.clip(mid, 0, m - 1)]
        less = words_less(mid_rows, query_words)
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    idx = jnp.clip(lo, 0, m - 1)
    found = jnp.all(uniq_words[idx] == query_words, axis=-1)
    return idx, found


PREFIX_BITS = 20


def prefix_table(uniq_words: np.ndarray):
    """Host-built first-level bucket index for searchsorted_words_pref.

    Buckets rows of a sorted (M, W) spectrum by the high PREFIX_BITS of
    the most-significant word (2^20 buckets = 4 MB table). Returns
    (ptable (2^PB + 1,) int32 device array, steps) where ptable[key] is
    the first row whose key >= key and `steps` is the static in-bucket
    binary-search depth (log2 of the largest bucket) — cuts the search
    from log2(M) to a couple of gather steps. Sentinel rows key to the
    last bucket and stay inert.
    """
    rows = np.asarray(uniq_words)
    key = (rows[:, -1].astype(np.uint32) >> (32 - PREFIX_BITS)).astype(
        np.int64)
    nb = 1 << PREFIX_BITS
    ptable = np.searchsorted(key, np.arange(nb), side="left")
    ptable = np.concatenate([ptable, [len(rows)]]).astype(np.int32)
    maxb = int((ptable[1:] - ptable[:-1]).max()) if len(rows) else 1
    return jnp.asarray(ptable), max(1, maxb.bit_length())


def searchsorted_words_pref(uniq_words, query_words, ptable, steps: int):
    """searchsorted_words with a prefix-table head start: identical
    (idx, found) for found queries; for misses `found` is identically
    False but idx is unspecified (callers use idx only under found)."""
    from kmerax.core.codec import words_less

    m = uniq_words.shape[0]
    key = (query_words[..., -1] >> (32 - PREFIX_BITS)).astype(jnp.int32)
    lo = ptable[key]
    hi = ptable[key + 1]
    for _ in range(steps):
        mid = (lo + hi) // 2
        mid_rows = uniq_words[jnp.clip(mid, 0, m - 1)]
        less = words_less(mid_rows, query_words)
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    idx = jnp.clip(lo, 0, m - 1)
    found = jnp.all(uniq_words[idx] == query_words, axis=-1)
    return idx, found


def lookup_sorted(uniq_words: jnp.ndarray, counts: jnp.ndarray,
                  query_words: jnp.ndarray):
    """Counts for queries against a deduped sorted spectrum: (counts, found)."""
    idx, found = searchsorted_words(uniq_words, query_words)
    return jnp.where(found, counts[idx], 0), found
