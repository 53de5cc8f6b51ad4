"""K-mer hashing for Bloom probes and bucketing (SURVEY.md §2 #4).

murmur3 fmix32 over uint32 lanes; semantics frozen in DESIGN.md §3 and
bit-exact vs oracle.codec.mix32 / kmer_hash_words.
"""

from __future__ import annotations

import jax.numpy as jnp

HASH_SEED_1 = 0x9E3779B1
HASH_SEED_2 = 0x85EBCA77


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


def mix32(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3 finalizer; wrapping uint32 arithmetic."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * _u32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * _u32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def kmer_hash(words: jnp.ndarray, seed: int) -> jnp.ndarray:
    """h = mix32(seed); for w in words: h = mix32(h ^ w). words: (..., W)."""
    h = mix32(jnp.full(words.shape[:-1], seed, dtype=jnp.uint32))
    for i in range(words.shape[-1]):
        h = mix32(h ^ words[..., i])
    return h


def hash_bucket(words: jnp.ndarray, log2_width: int,
                log2_buckets: int) -> jnp.ndarray:
    """Hash-derived bucket (DESIGN.md §5a): the log2_buckets bits of h1 just
    above the within-segment block offset. Uniform by construction and far
    cheaper than a minimizer scan (no per-m-mer mix rounds), at the cost of
    the super-k-mer routing locality minimizers would give. Returns uint32."""
    seg_blocks_bits = log2_width - 7 - log2_buckets
    h1 = kmer_hash(words, HASH_SEED_1)
    return (h1 >> seg_blocks_bits) & _u32((1 << log2_buckets) - 1)


def bloom_blocks_lanes(words: jnp.ndarray, log2_width: int, d: int,
                       buckets: jnp.ndarray | None, log2_buckets: int):
    """Register-blocked Bloom addressing (DESIGN.md §5).

    Every k-mer maps to ONE 128-lane block inside its bucket's segment (a
    512-byte row of int32 counters); its d probes are lanes within that
    block.

    `buckets=None` selects the hash-derived scheme (DESIGN.md §5a): bucket
    and block offset are disjoint bit ranges of h1, so the global block is
    simply the low (log2_width - 7) bits of h1.
    Returns (block (...) int32 global block index, lanes (..., d) int32).
    """
    assert d <= 4
    seg_blocks_bits = log2_width - 7 - log2_buckets
    h1 = kmer_hash(words, HASH_SEED_1)
    h2 = kmer_hash(words, HASH_SEED_2)
    if buckets is None:
        block = h1 & _u32((1 << (log2_width - 7)) - 1)
    else:
        mask = _u32((1 << seg_blocks_bits) - 1)
        block = (buckets.astype(jnp.uint32) << seg_blocks_bits) | (h1 & mask)
    lanes = jnp.stack(
        [(h2 >> (7 * i)) & _u32(127) for i in range(d)], axis=-1)
    return block.astype(jnp.int32), lanes.astype(jnp.int32)


def bloom_indices(words: jnp.ndarray, log2_width: int, d: int,
                  buckets: jnp.ndarray | None, log2_buckets: int) -> jnp.ndarray:
    """Flat global probe indices (..., d) = 128*block + lane (DESIGN.md §5)."""
    block, lanes = bloom_blocks_lanes(words, log2_width, d,
                                      buckets, log2_buckets)
    return (block[..., None] << 7) | lanes
