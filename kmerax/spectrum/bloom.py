"""Device-HBM counting-Bloom spectrum (SURVEY.md §2 #10; DESIGN.md §5).

The "sharded device-HBM counting array" of BASELINE.json: ONE logical Bloom
table segmented by minimizer bucket — every probe of a k-mer lands inside its
bucket's contiguous segment, so the table can be range-sharded over the mesh
"bucket" axis (DESIGN.md §12) while its *contents* stay identical for every
mesh shape (DESIGN.md §13 determinism).

Insert uses a sort + segment-sum dedup so the final scatter has
mostly-unique indices (BASELINE.json "JAX segment-sum scatters"), which XLA
parallelizes far better than a collision-heavy scatter.

All functions are pure and jit-safe; the table threads through functionally.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from kmerax.core.hash import bloom_indices
from kmerax.core.minimizer import minimizers

COUNT_SATURATE = 1 << 30
SAT16 = (1 << 15) - 1               # p16 counter saturation ceiling


@dataclass(frozen=True)
class BloomParams:
    k: int
    log2_width: int                 # GLOBAL table width = 2^log2_width
    num_hashes: int = 4
    minimizer_m: int = 11
    log2_buckets: int = 8           # T = 2^log2_buckets segments
    bucket_scheme: str = "hash"     # "hash" (DESIGN.md §5a) | "minimizer" (§4)
    # counter storage: "i32" = one int32 per counter; "p16" = two
    # saturating 16-bit counters packed per int32 word (block-row pairs) —
    # half the table bytes for the same width.
    # Saturation at SAT16 is batch-order-independent (min(sum, SAT16)), and
    # solidity is unchanged for any threshold t <= SAT16.
    counter: str = "i32"

    def __post_init__(self):
        assert self.log2_buckets <= self.log2_width - 7 <= 31
        assert self.num_hashes <= 4
        assert self.bucket_scheme in ("hash", "minimizer")
        assert self.counter in ("i32", "p16")
        if self.counter == "p16":
            assert self.log2_width >= 9, "p16 needs >= 2 block rows"

    @property
    def width(self) -> int:
        return 1 << self.log2_width

    @property
    def table_entries(self) -> int:
        """int32 words in the table array (width for i32, width/2 for p16)."""
        return self.width if self.counter == "i32" else self.width // 2


def make_table(params: BloomParams) -> jnp.ndarray:
    # jit so the zeros materialize ON DEVICE: a plain jnp.zeros is staged
    # host-side and pays a full-table H2D on first use
    return jax.jit(jnp.zeros, static_argnums=(0, 1))(
        params.table_entries, jnp.int32)


def pack16(table_i32: jnp.ndarray) -> jnp.ndarray:
    """(width,) int32 counters -> (width/2,) p16 words: adjacent 128-lane
    BLOCK ROWS pair into one word row, word[r,l] = cnt[2r,l] | cnt[2r+1,l]<<16
    (counters must already be <= SAT16)."""
    t = table_i32.reshape(-1, 2, 128)
    return (t[:, 0] | (t[:, 1] << 16)).reshape(-1)


def unpack16(packed: jnp.ndarray) -> jnp.ndarray:
    """Inverse of pack16: (width/2,) p16 words -> (width,) int32 counters."""
    w = packed.reshape(-1, 128)
    lo = w & 0xFFFF
    hi = (w >> 16) & 0xFFFF
    return jnp.stack([lo, hi], axis=1).reshape(-1)


def bucket_of(params: BloomParams, canon_words: jnp.ndarray) -> jnp.ndarray:
    """Segment-owner bucket per the configured scheme (uint32)."""
    if params.bucket_scheme == "hash":
        from kmerax.core.hash import hash_bucket
        return hash_bucket(canon_words, params.log2_width,
                           params.log2_buckets)
    return (minimizers(canon_words, params.k, params.minimizer_m)
            % jnp.uint32(1 << params.log2_buckets))


def _scheme_buckets(params: BloomParams, canon_words: jnp.ndarray):
    """None for the hash scheme (bucket folds into h1 — no extra compute)."""
    if params.bucket_scheme == "hash":
        return None
    return (minimizers(canon_words, params.k, params.minimizer_m)
            % jnp.uint32(1 << params.log2_buckets))


def probe_indices(params: BloomParams, canon_words: jnp.ndarray) -> jnp.ndarray:
    """Global probe indices (..., d) per the configured bucket scheme."""
    return bloom_indices(canon_words, params.log2_width, params.num_hashes,
                         _scheme_buckets(params, canon_words),
                         params.log2_buckets)


def blocks_lanepack(params: BloomParams, canon_words: jnp.ndarray):
    """(block (...) int32, lanepack (...) int32 with d 7-bit lanes packed) —
    the one-block addressing form of the d probes (DESIGN.md §5)."""
    from kmerax.core.hash import bloom_blocks_lanes

    block, lanes = bloom_blocks_lanes(
        canon_words, params.log2_width, params.num_hashes,
        _scheme_buckets(params, canon_words), params.log2_buckets)
    lp = lanes[..., 0]
    for j in range(1, params.num_hashes):
        lp = lp | (lanes[..., j] << (7 * j))
    return block, lp


def insert(params: BloomParams, table: jnp.ndarray,
           canon_words: jnp.ndarray, valid: jnp.ndarray,
           local_bits: int | None = None) -> jnp.ndarray:
    """Add one batch of canonical k-mers to the table (or a range shard).

    `local_bits`: when the table is a 2^local_bits range shard (DESIGN.md
    §12), global indices are masked to shard-local offsets.

    All d probes live in one 128-lane block (DESIGN.md §5), so the insert
    is ONE vectorized row scatter-add per k-mer: build the d-lane one-hot
    row and `table2d.at[block].add(row)` (commutative adds; invalid k-mers
    scatter to a dropped out-of-range block).

    p16 tables saturate at SAT16 per batch: min(sum, SAT16) is associative
    over batch splits, so results stay order/mesh independent.
    """
    if params.counter == "p16":
        import dataclasses
        t32 = unpack16(table)
        t32 = insert(dataclasses.replace(params, counter="i32"),
                     t32, canon_words, valid, local_bits=local_bits)
        return pack16(jnp.minimum(t32, SAT16))
    from kmerax.core.hash import bloom_blocks_lanes

    d = params.num_hashes
    block, lanes = bloom_blocks_lanes(
        canon_words, params.log2_width, d,
        _scheme_buckets(params, canon_words), params.log2_buckets)
    if local_bits is not None:
        block = block & ((1 << (local_bits - 7)) - 1)
    nrows = table.shape[0] // 128
    block = jnp.where(valid, block, nrows)            # dropped
    fb = block.reshape(-1)
    fl = lanes.reshape(-1, d)
    n = fb.shape[0]
    table2d = table.reshape(nrows, 128)
    pos = jnp.arange(128, dtype=jnp.int32)[None, :]

    CHUNK = 1 << 18
    if n <= CHUNK:
        oh = sum((fl[:, j:j + 1] == pos).astype(jnp.int32) for j in range(d))
        return table2d.at[fb].add(oh, mode="drop").reshape(-1)

    pad = (-n) % CHUNK
    fb = jnp.concatenate([fb, jnp.full(pad, nrows, jnp.int32)])
    fl = jnp.concatenate([fl, jnp.zeros((pad, d), jnp.int32)])

    def body(i, t):
        b = jax.lax.dynamic_slice(fb, (i * CHUNK,), (CHUNK,))
        l = jax.lax.dynamic_slice(fl, (i * CHUNK, 0), (CHUNK, d))
        oh = sum((l[:, j:j + 1] == pos).astype(jnp.int32) for j in range(d))
        return t.at[b].add(oh, mode="drop")

    table2d = jax.lax.fori_loop(0, (n + pad) // CHUNK, body, table2d)
    return table2d.reshape(-1)


def solidity_bitmap(params: BloomParams, table: jnp.ndarray,
                    t: int | jnp.ndarray) -> jnp.ndarray:
    """Pack (table >= t) into a uint32 bitmap, 32 counters per word.

    The corrector only ever consumes `count >= t` (DESIGN.md §8: every
    decision is a solidity test), so the correction pass can query this
    bitmap instead of the int32 table — bit-identical results with a 128x
    smaller working set (2^LW bits vs 2^LW * 4 bytes; a 2^24-counter table
    packs to 2 MB), and 128x less all-gather/H2D traffic when replicating
    the merged spectrum.
    """
    if params.counter == "p16":
        table = unpack16(table)
    bits = (table.reshape(-1, 32) >= t).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)


def query_solid(params: BloomParams, bitmap: jnp.ndarray,
                canon_words: jnp.ndarray,
                valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """Solidity test against a packed bitmap: AND over the d probes.

    Equivalent to `query(...) >= t` for the `t` the bitmap was built with
    (min over probes >= t  <=>  every probe >= t). Invalid lanes -> False.

    All d probes of a k-mer live in ONE 128-bit block = 4 consecutive
    bitmap words (DESIGN.md §5), so the whole test is a single 16-byte row
    gather from the (width/128, 4) bitmap view + vectorized bit tests.
    """
    block, lp = blocks_lanepack(params, canon_words)
    rows = bitmap.reshape(-1, 4)[block]                     # (..., 4) uint32
    lp = lp.astype(jnp.uint32)
    solid = None
    for j in range(params.num_hashes):
        l7 = (lp >> (7 * j)) & jnp.uint32(127)
        widx = (l7 >> 5).astype(jnp.int32)                  # word 0..3
        word = rows[..., 0]
        for i in range(1, 4):
            word = jnp.where(widx == i, rows[..., i], word)
        bit = (word >> (l7 & jnp.uint32(31))) & jnp.uint32(1)
        solid = (bit == 1) if solid is None else solid & (bit == 1)
    if valid is not None:
        solid = solid & valid
    return solid


def query(params: BloomParams, table: jnp.ndarray,
          canon_words: jnp.ndarray,
          valid: jnp.ndarray | None = None,
          local_bits: int | None = None) -> jnp.ndarray:
    """count = min over d probes, saturated; invalid lanes -> 0.

    All d probes share the k-mer's 128-lane block (DESIGN.md §5), so the 4
    flat gathers hit one 512-byte block.
    """
    idx = probe_indices(params, canon_words)
    if local_bits is not None:
        idx = idx & ((1 << local_bits) - 1)
    if params.counter == "p16":
        # counter c lives at packed word (blockrow(c)>>1)*128 + lane(c),
        # halfword blockrow(c)&1 (pack16 layout)
        brow = idx >> 7
        widx = ((brow >> 1) << 7) | (idx & 127)
        w = table[widx]
        vals = jnp.where((brow & 1) == 1, (w >> 16) & 0xFFFF, w & 0xFFFF)
        counts = jnp.min(vals, axis=-1)
    else:
        counts = jnp.min(table[idx], axis=-1)
    counts = jnp.minimum(counts, COUNT_SATURATE)
    if valid is not None:
        counts = jnp.where(valid, counts, 0)
    return counts
