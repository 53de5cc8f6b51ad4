"""Rolling k-mer extraction from base arrays (SURVEY.md §2 #2).

Vectorized shift-or folds over static base windows — XLA fuses the whole
extraction into a handful of vector passes; no gathers, no dynamic shapes.
"""

from __future__ import annotations

import jax.numpy as jnp

from kmerax.core.codec import num_words


def extract_kmers(bases: jnp.ndarray, k: int):
    """All k-mer windows of each read.

    Args:
      bases: (..., L) integer base codes (0..3 valid, >=4 invalid).
      k: static odd k, 0 < k <= 63.
    Returns:
      words: (..., L-k+1, W) uint32 little-endian packed forward k-mers
             (garbage where invalid).
      valid: (..., L-k+1) bool — window contains no invalid base.
    """
    L = bases.shape[-1]
    assert L >= k, f"read length {L} < k {k}"
    w = num_words(k)
    nk = L - k + 1
    b32 = (bases & 7).astype(jnp.uint32)  # mask so invalid bases can't bleed

    words = []
    for wi in range(w):
        lo = max(k - 16 * (wi + 1), 0)
        hi = k - 16 * wi
        acc = jnp.zeros(bases.shape[:-1] + (nk,), dtype=jnp.uint32)
        for i in range(lo, hi):
            acc = (acc << 2) | (b32[..., i:i + nk] & 3)
        words.append(acc)
    words = jnp.stack(words, axis=-1)

    bad = (bases >= 4).astype(jnp.int32)
    cum = jnp.cumsum(bad, axis=-1)
    zero = jnp.zeros_like(cum[..., :1])
    cum = jnp.concatenate([zero, cum], axis=-1)          # (..., L+1)
    valid = (cum[..., k:] - cum[..., :nk]) == 0
    return words, valid
