"""Banded seed-extend alignment as a Pallas kernel for the GPU (Triton
route): the DP of ops.align.banded_align_scores with no DP row ever stored.

The XLA path materialises every DP row into a (B, n+1, W) int32 buffer and
launches a few small kernels per row. Here one program owns BR reads and
walks all n rows in registers:

  * each of the W = 2*band+1 band diagonals is its own (BR,) register
    vector (reads across threads), so the "up" neighbour S[i-1][j] is just
    the next diagonal's vector — no lane shifts, which the Triton route
    cannot express on a value;
  * the linear-gap within-row dependency S[i][j] = max(M[i][j],
    S[i][j-1] + GAP) runs as a sequential pass over the diagonals — the
    same integers as the XLA path's max-plus cummax identity;
  * target bases arrive as one coalesced (BR,) column load per DP row from
    the transposed target; the W-column window slides through the loop
    carry;
  * the final cell is harvested on the fly at the row where qlen == i, so
    no post-hoc gather exists.

Scoring constants come from ops.align so the two paths cannot drift.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from kmerax.ops.align import GAP, MATCH, MISMATCH, NEG_INF

BR = 64                        # reads per program
NUM_WARPS = 2


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _pick(row, dfin):
    """row[dfin] per read from the list of diagonal vectors."""
    out = row[0]
    for d in range(1, len(row)):
        out = jnp.where(dfin == d, row[d], out)
    return out


def _band_kernel(n: int, band: int, tT_ref, qT_ref, qlen_ref, tlen_ref,
                 out_ref):
    """Score BR banded alignments.

    tT_ref: (LT, BR) int32, target padded with band+1 base-4 sentinels on
      top, so diagonal d of DP row i reads target[j-1] = tT[i + d] for
      j = i + d - band.
    qT_ref: (LQ, BR) int32, query[i-1] at row i-1.
    qlen_ref / tlen_ref: (BR,) int32.
    out_ref: (BR,) int32, the final cell S[qlen][tlen] (NEG_INF when no
      in-band path reaches it); the |tlen-qlen| <= band gate is applied by
      the wrapper, as in ops.align.banded_align_scores.
    """
    W = 2 * band + 1
    qlen = qlen_ref[...]
    tl = tlen_ref[...]
    ninf = jnp.full_like(qlen, NEG_INF)
    dfin = jnp.clip(tl - qlen + band, 0, W - 1)

    # row 0: S[0][j] = GAP*j for 0 <= j <= min(band, tlen), else -inf
    row0 = tuple(
        jnp.where((d - band >= 0) & (d - band <= tl), GAP * (d - band),
                  NEG_INF) for d in range(W))
    score0 = jnp.where(qlen == 0, _pick(row0, dfin), ninf)
    win0 = tuple(tT_ref[d, :] for d in range(1, W))

    def body(i, carry):
        prev, win, score = carry
        win = win + (tT_ref[i + W - 1, :],)
        qi = qT_ref[i - 1, :]
        qok = qi < 4
        c0 = i <= band
        row = []
        run = None
        for d in range(W):
            j = i + d - band
            sub = jnp.where((win[d] == qi) & qok, MATCH, MISMATCH)
            up = (prev[d + 1] if d + 1 < W else ninf) + GAP
            valid = (j >= 1) & (j <= tl)
            mv = jnp.where(valid, jnp.maximum(prev[d] + sub, up), NEG_INF)
            is0 = (j == 0) & c0
            # vector operands: an all-scalar select mis-lowers on Triton
            m = jnp.maximum(mv, jnp.where(is0, GAP * i, ninf))
            run = m if d == 0 else jnp.maximum(m, run + GAP)
            row.append(jnp.where(valid | is0, run, NEG_INF))
        row = tuple(row)
        ends = qlen == i
        score = jax.lax.cond(
            jnp.max(ends.astype(jnp.int32)) > 0,
            lambda s: jnp.where(ends, _pick(row, dfin), s),
            lambda s: s, score)
        return row, win[1:], score

    _, _, score = jax.lax.fori_loop(1, n + 1, body, (row0, win0, score0))
    out_ref[...] = score


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _band_call(n: int, band: int, interpret: bool, tT, qT, qlen, tlen):
    LT, Bp = tT.shape
    LQ = qT.shape[0]
    return pl.pallas_call(
        functools.partial(_band_kernel, n, band),
        out_shape=jax.ShapeDtypeStruct((Bp,), jnp.int32),
        grid=(Bp // BR,),
        in_specs=[
            pl.BlockSpec((LT, BR), lambda p: (0, p)),
            pl.BlockSpec((LQ, BR), lambda p: (0, p)),
            pl.BlockSpec((BR,), lambda p: (p,)),
            pl.BlockSpec((BR,), lambda p: (p,)),
        ],
        out_specs=pl.BlockSpec((BR,), lambda p: (p,)),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="band_align",
    )(tT, qT, qlen, tlen)


def banded_align_scores_pallas(query, target, qlen, tlen, band: int, *,
                               interpret: bool = False):
    """Kernel drop-in for ops.align.banded_align_scores: (B,) int32 scores,
    bit-identical (same recurrence, same NEG_INF contract)."""
    B, n = query.shape
    m = target.shape[1]
    W = 2 * band + 1
    assert W <= 128, "band must fit one vector register row"
    Bp = -(-B // BR) * BR
    # row i reads tT[i .. i+W-1]; i <= n. Power-of-two rows for Triton.
    LT = _pow2(max(n + W, band + 1 + m))
    LQ = _pow2(max(n, 1))
    tpad = jnp.full((Bp, LT), 4, jnp.int32).at[:B, band + 1:band + 1 + m].set(
        target.astype(jnp.int32))
    qpad = jnp.full((Bp, LQ), 4, jnp.int32).at[:B, :n].set(
        query.astype(jnp.int32))
    zpad = lambda a: jnp.zeros(Bp, jnp.int32).at[:B].set(a.astype(jnp.int32))
    score = _band_call(n, band, interpret, tpad.T, qpad.T, zpad(qlen),
                       zpad(tlen))[:B]
    return jnp.where(jnp.abs(tlen - qlen) <= band, score, NEG_INF)
