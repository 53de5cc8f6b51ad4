"""De-Bruijn graph construction from the exact spectrum (SURVEY.md §2 #15).

Nodes are rows of the sorted unique-kmer array; edges are discovered with
eight batched binary searches per node (4 bases × 2 orientations) — the
Data-parallel replacement for hash-table probing. Semantics: DESIGN.md §9.
"""

from __future__ import annotations

import jax.numpy as jnp

from kmerax.core.codec import canonical_words, num_words, revcomp_words
from kmerax.spectrum.exact import searchsorted_words


def shift_append_base(words: jnp.ndarray, b: int, k: int) -> jnp.ndarray:
    """suffix_{k-1}(kmer)·4 + b over little-endian words: (x << 2 | b) mod 4^k."""
    w = num_words(k)
    carry = jnp.concatenate(
        [jnp.full_like(words[..., :1], b), words[..., :-1] >> 30], axis=-1)
    x = (words << 2) | carry
    top_bits = 2 * k - 32 * (w - 1)          # bits used in the top word
    mask = jnp.uint32((1 << top_bits) - 1)
    return jnp.concatenate([x[..., :-1], x[..., -1:] & mask], axis=-1)


def build_edges(uniq: jnp.ndarray, solid: jnp.ndarray, k: int,
                rows: jnp.ndarray | None = None):
    """Edge structure of the solid-kmer dBG.

    Args:
      uniq: (C, W) sorted unique canonical k-mers (sentinel padded).
      solid: (C,) bool — node mask (count >= t).
      rows: optional (n,) node ids to build edges FOR (the distributed path
        shards rows across devices); default all C rows.
    Returns dict of (n, 2)-shaped arrays over orientations o∈{0=+,1=-}:
      succ_v / succ_o: unique out-edge target (undefined unless outdeg==1),
      outdeg: int32, internal: bool (DESIGN.md §9 unitig-internal rule).
      The `internal` flag here uses only local+target outdegree and is
      finalized by the caller when rows are sharded.
    """
    C, W = uniq.shape
    full_rows = rows is None
    if full_rows:
        rows = jnp.arange(C, dtype=jnp.int32)
        my = uniq
    else:
        my = uniq[rows]
    orientations = [my, revcomp_words(my, k)]

    outdeg = []
    succ_v, succ_o = [], []
    n = rows.shape[0]
    for o, f in enumerate(orientations):
        exists_any = jnp.zeros(n, dtype=jnp.int32)
        v_sel = jnp.zeros(n, dtype=jnp.int32)
        o_sel = jnp.zeros(n, dtype=jnp.int32)
        for b in range(4):
            wext = shift_append_base(f, b, k)
            cw, is_fwd = canonical_words(wext, k)
            idx, found = searchsorted_words(uniq, cw)
            ex = found & solid[idx]
            # keep the unique edge when outdeg==1: any-select is fine
            v_sel = jnp.where(ex, idx, v_sel)
            o_sel = jnp.where(ex, jnp.where(is_fwd, 0, 1), o_sel)
            exists_any = exists_any + ex.astype(jnp.int32)
        outdeg.append(exists_any)
        succ_v.append(v_sel)
        succ_o.append(o_sel)

    outdeg = jnp.stack(outdeg, axis=1)        # (n, 2)
    succ_v = jnp.stack(succ_v, axis=1)
    succ_o = jnp.stack(succ_o, axis=1)
    edges = {"succ_v": succ_v, "succ_o": succ_o, "outdeg": outdeg}
    if full_rows:
        # single-device path: the local table IS the full table
        edges["internal"] = finalize_internal(
            outdeg, outdeg, succ_v, succ_o, rows, solid)
    return edges


def finalize_internal(outdeg_local, outdeg_full, succ_v, succ_o,
                      rows, solid_local):
    """internal: outdeg(u,o)==1 & outdeg(v,¬o')==1 & v!=u & solid(u).

    Target outdegree comes from the FULL table — in the distributed path
    the per-shard outdegrees are all-gathered first (collective join).
    """
    tgt_back = outdeg_full[succ_v, 1 - succ_o]
    return ((outdeg_local == 1) & (tgt_back == 1)
            & (succ_v != rows[:, None]) & solid_local[:, None])
