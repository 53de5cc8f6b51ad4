"""2-bit host<->device wire format for read batches (SURVEY.md §1 L1).

Read batches cross the host<->device link every batch, in both
directions. The int8 wire already cuts the link bytes 4x vs int32; this
module cuts another 4x by packing four 2-bit base codes per byte:

  H2D: host packs (B, L) base codes -> (B, ceil(L/4)) uint8; the device
       unpacks with two shifts and rebuilds the padding (code 4) from
       `lengths` — so downstream stages see exactly the (B, L) int32
       rows padded with 4 that the int8 wire produced.
  D2H: the corrected batch packs on-device to (B, ceil(L/4)) uint8 and
       the host unpacks; the FASTQ writer only reads row[:length], and
       within length an N-free batch is pure 0..3.

N bases (code 4) cannot ride in 2 bits. Padding is reconstructed from
`lengths`, and IN-READ Ns are rare, so the driver tests each batch with
`batch_has_n` (one vectorized pass) and falls back to the int8 wire for
the few batches that carry real Ns — output bytes are identical either
way (tests/golden/test_wire_pipeline.py).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def packed_cols(L: int) -> int:
    """Wire columns for L bases: ceil(L/4)."""
    return (L + 3) // 4


def batch_has_n(bases: np.ndarray, lengths: np.ndarray) -> bool:
    """True iff any IN-READ base is code 4 (N).

    Rows are padded past `lengths` with 4 (io/batcher.py), so the batch
    is N-free exactly when the total number of 4s equals the padding
    count — one vectorized pass, no per-row masking.
    """
    n_four = int((bases == 4).sum())
    n_pad = bases.shape[0] * bases.shape[1] - int(lengths.sum())
    return n_four != n_pad


def pack2_host(bases: np.ndarray) -> np.ndarray:
    """(B, L) codes -> (B, ceil(L/4)) uint8, 4 bases/byte little-endian.

    Codes >= 4 (padding) pack as their low bits; the device unpack
    restores them from `lengths`, so only N-free batches may use this
    path (see batch_has_n).
    """
    B, L = bases.shape
    L4 = packed_cols(L) * 4
    b = (bases.astype(np.uint8) & 3)
    if L4 != L:
        b = np.concatenate(
            [b, np.zeros((B, L4 - L), np.uint8)], axis=1)
    b = b.reshape(B, L4 // 4, 4)
    return (b[:, :, 0] | (b[:, :, 1] << 2) | (b[:, :, 2] << 4)
            | (b[:, :, 3] << 6))


def unpack2_dev(packed, lengths, L: int):
    """Device unpack: (B, ceil(L/4)) uint8 -> (B, L) int8, pad rebuilt
    as 4 past `lengths` (the int8-wire contract downstream expects)."""
    p = packed.astype(jnp.int32)
    shifts = jnp.arange(4, dtype=jnp.int32) * 2
    b = (p[:, :, None] >> shifts[None, None, :]) & 3
    b = b.reshape(p.shape[0], -1)[:, :L]
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    return jnp.where(pos < lengths[:, None], b, 4).astype(jnp.int8)


def unpack2_dev_all(packed, lengths):
    """Device unpack without a static L: (B, cols) uint8 -> (B, 4*cols)
    int8 with pad=4 past `lengths`.

    The up-to-3 extra columns vs the original L are padding (4) by the
    lengths mask, so every downstream consumer (k-mer extraction,
    correction) produces identical results — only the compiled shape
    differs. Lets jitted steps dispatch on the WIRE DTYPE alone (uint8 =
    packed, int8 = legacy) with no extra static argument."""
    return unpack2_dev(packed, lengths, packed.shape[1] * 4)


def pack2_dev(bases):
    """Device pack: (B, L) codes -> (B, ceil(L/4)) uint8.

    Values >= 4 (padding past length) pack as garbage low bits; the host
    consumer only reads row[:length] (FastqWriter slice)."""
    B, L = bases.shape
    L4 = packed_cols(L) * 4
    b = bases.astype(jnp.uint8) & 3
    if L4 != L:
        b = jnp.concatenate(
            [b, jnp.zeros((B, L4 - L), jnp.uint8)], axis=1)
    b = b.reshape(B, L4 // 4, 4)
    return (b[:, :, 0] | (b[:, :, 1] << 2) | (b[:, :, 2] << 4)
            | (b[:, :, 3] << 6))


def unpack2_host(packed: np.ndarray, L: int) -> np.ndarray:
    """Host unpack: (B, ceil(L/4)) uint8 -> (B, L) uint8 codes 0..3.

    Positions past the read length are garbage (callers slice to
    length, matching the int8-wire contract)."""
    p = packed[:, :, None]
    shifts = (np.arange(4, dtype=np.uint8) * 2)[None, None, :]
    b = (p >> shifts) & 3
    return b.reshape(packed.shape[0], -1)[:, :L]
