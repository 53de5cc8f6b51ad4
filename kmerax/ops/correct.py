"""Spectrum-based error correction, vectorized over a read batch.

Bit-exact implementation of the frozen algorithm in DESIGN.md §8 v2 ("C++
SIMD correction loop → vectorized spectrum lookup+edit", BASELINE.json:5).
v2 is the data-parallel formulation: every candidate of a round is scored
in ONE fused pass against the round-start read (a single large
spectrum-probe batch), then edits are applied simultaneously under a
deterministic conflict-suppression rule. This replaced v1's sequential
per-candidate loop, whose per-slot dispatch overhead dominated correction
wall time.

`query_fn(canon_words, valid) -> int32 counts` abstracts the spectrum
(counting Bloom, exact sorted, or bucket-sharded).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kmerax.core.codec import canonical_words
from kmerax.core.kmers import extract_kmers


def _weak_run_candidates(solid, existing, last_j, k, max_runs):
    """Candidate edit positions per read (DESIGN.md §8), -1 = absent.

    Returns (B, 2*max_runs) int32, in run order, deduped keeping first.
    """
    B, nk = solid.shape
    weak = existing & ~solid
    prev_weak = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=bool), weak[:, :-1]], axis=1)
    next_weak = jnp.concatenate(
        [weak[:, 1:], jnp.zeros((B, 1), dtype=bool)], axis=1)
    run_start = weak & ~prev_weak
    run_end = weak & ~next_weak
    run_id = jnp.cumsum(run_start.astype(jnp.int32), axis=1) - 1

    # r-th run's [j0, j1] via per-run argmax reduces — vectorized passes
    # instead of element scatters
    j0s, j1s, haves = [], [], []
    for r in range(max_runs):
        ms = run_start & (run_id == r)
        me = run_end & (run_id == r)
        j0s.append(jnp.argmax(ms, axis=1).astype(jnp.int32))
        j1s.append(jnp.argmax(me, axis=1).astype(jnp.int32))
        haves.append(jnp.any(ms, axis=1))
    have = jnp.stack(haves, axis=1)                       # (B, max_runs)
    j0 = jnp.where(have, jnp.stack(j0s, axis=1), -1)
    j1 = jnp.where(have, jnp.stack(j1s, axis=1), -1)
    lj = last_j[:, None]

    interior = (j0 > 0) & (j1 < lj)
    left_e = (j0 == 0) & (j1 < lj)
    right_e = (j0 > 0) & (j1 == lj)
    # whole-read-weak = (j0==0)&(j1==lj): cand_a=j1, cand_b=j0+k-1
    cand_a = jnp.where(interior | right_e, j0 + k - 1, j1)
    cand_b = jnp.where(interior, j1,
                       jnp.where(left_e | right_e, -1, j0 + k - 1))
    cand_a = jnp.where(have, cand_a, -1)
    cand_b = jnp.where(have, cand_b, -1)
    cands = jnp.stack([cand_a, cand_b], axis=-1).reshape(B, 2 * max_runs)

    # dedupe keeping first occurrence (static O(C^2), C small)
    C = 2 * max_runs
    cols = [cands[:, c] for c in range(C)]
    for c in range(1, C):
        dup = jnp.zeros(B, dtype=bool)
        for c2 in range(c):
            dup = dup | ((cols[c] == cols[c2]) & (cols[c2] >= 0))
        cols[c] = jnp.where(dup, -1, cols[c])
    return jnp.stack(cols, axis=1)


def _window_counts(bases, last_j, k, solid_fn):
    """Round-start solidity over all windows. Returns (solid, existing)."""
    words, valid = extract_kmers(bases, k)
    canon, _ = canonical_words(words, k)
    nk = bases.shape[1] - k + 1
    j = jnp.arange(nk, dtype=jnp.int32)
    existing = j[None, :] <= last_j[:, None]
    solid = solid_fn(canon, valid) & existing
    return solid, existing


def _eval_entries(bases, lengths, last_j, ent_r, ent_i, k, solid_fn):
    """Score all four substitutions for each flat (read, position) entry
    against the round-start bases (DESIGN.md §8 v2). Entries with
    ent_i < 0 are padding. Returns (best_b (Q,), accept (Q,))."""
    B, L = bases.shape
    Q = ent_r.shape[0]
    ic = jnp.clip(ent_i, 0, L - 1)
    lens_e = lengths[ent_r]
    lj_e = last_j[ent_r]

    offs = ic[:, None] + jnp.arange(-(k - 1), k, dtype=jnp.int32)  # (Q, 2k-1)
    oob = (offs < 0) | (offs >= lens_e[:, None])
    wb = bases[ent_r[:, None], jnp.clip(offs, 0, L - 1)]
    wb = jnp.where(oob, 4, wb)                                     # (Q, 2k-1)

    # Extract window words ONCE per entry, then derive the 4 center-base
    # variants by XOR-ing the (statically positioned) center bits — the
    # shift-register fold costs ~30 passes over (Q,4,k) when re-run per
    # variant vs 3 cheap ops here. Window j covers wb[j : j+k]; the center
    # sits at window-relative q = k-1-j; core.kmers packs little-endian
    # word wi over window positions [max(k-16(wi+1),0), k-16wi) with the
    # leftmost base highest, so q lives at shift 2*(hi-1-q) of word wi —
    # all static per j. An N center packs as 0 bits ((b&7)&3) and deltas
    # use old&3, so variants overwrite it correctly; window validity is
    # computed with the center forced valid (every variant has a real base
    # there), matching the per-variant extraction exactly.
    import numpy as _np
    W = (k + 15) // 16
    wi_j = _np.empty(k, _np.int32)
    sh_j = _np.empty(k, _np.int32)
    for j in range(k):
        q = k - 1 - j
        for wi in range(W):
            lo, hi = max(k - 16 * (wi + 1), 0), k - 16 * wi
            if lo <= q < hi:
                wi_j[j] = wi
                sh_j[j] = 2 * (hi - 1 - q)
    words0, _ = extract_kmers(wb, k)                               # (Q,k,W)
    _, wvalid = extract_kmers(wb.at[:, k - 1].set(0), k)           # (Q,k)

    old_c = (wb[:, k - 1] & 3).astype(jnp.uint32)                  # (Q,)
    bvals4 = jnp.arange(4, dtype=jnp.uint32)
    delta = ((old_c[:, None] ^ bvals4[None, :])[:, :, None]
             << jnp.asarray(sh_j, jnp.uint32)[None, None, :])      # (Q,4,k)
    at_word = (jnp.arange(W, dtype=jnp.int32)[None, None, None, :]
               == jnp.asarray(wi_j)[None, None, :, None])          # (1,1,k,W)
    words4 = words0[:, None] ^ jnp.where(at_word, delta[..., None],
                                         jnp.uint32(0))            # (Q,4,k,W)
    canon, _ = canonical_words(words4, k)

    jglob = ic[:, None] - (k - 1) + jnp.arange(k, dtype=jnp.int32)  # (Q,k)
    in_range = (jglob >= 0) & (jglob <= lj_e[:, None])
    wvalid4 = jnp.broadcast_to(wvalid[:, None, :], words4.shape[:-1])
    solid4 = solid_fn(canon, wvalid4) & in_range[:, None, :]
    scores = jnp.sum(solid4.astype(jnp.int32), axis=-1)            # (Q,4)

    cur = bases[ent_r, ic]
    cur_score = jnp.where(
        cur < 4,
        jnp.take_along_axis(scores, jnp.clip(cur, 0, 3)[:, None].astype(
            jnp.int32), axis=1)[:, 0],
        0)
    best_s = jnp.max(scores, axis=1)
    best_b = jnp.argmax(scores, axis=1).astype(bases.dtype)  # first max wins

    accept = ((ent_i >= 0) & (best_b != cur)
              & (best_s > cur_score) & (best_s >= 1))
    return best_b, accept


def correct_batch(bases, lengths, k: int, t: int, query_fn=None,
                  rounds: int = 2, max_runs: int = 8, max_edits: int = 8,
                  solid_fn=None, max_cands: int = 4,
                  uniform_width: bool = False):
    """Correct a padded read batch (DESIGN.md §8 v2), bit-exact vs oracle.

    Args:
      bases: (B, L) int32, padded past `lengths` with 4.
      lengths: (B,) int32 true read lengths.
      query_fn: (canon_words, valid) -> int32 counts (0 where invalid).
      solid_fn: (canon_words, valid) -> bool, equivalent to
        `query_fn(...) >= t` — the algorithm only ever consumes solidity
        (DESIGN.md §8), so a packed-bitmap predicate
        (spectrum.bloom.query_solid) gives bit-identical output with far
        less gather traffic. Exactly one of query_fn / solid_fn required.
      max_cands: per-round candidate cap (DESIGN.md §8 v2).
      uniform_width: REQUIRED when solid_fn contains collectives (the
        routed sharded-spectrum path): replaces the data-dependent width
        dispatch with one unconditional full-width apply per round, so
        every mesh device executes the identical collective schedule.
        Bit-identical output: an all-padding apply accepts nothing and
        marks the read done, exactly like the skipped branch.
    Returns (corrected bases (B, L) int32, n_edits (B,) int32 — edits kept;
    0 where the read was reverted for exceeding max_edits).
    """
    if solid_fn is None:
        assert query_fn is not None, "need query_fn or solid_fn"
        solid_fn = lambda cw, v: (query_fn(cw, v) >= t) & v
    B, L = bases.shape
    bases = bases.astype(jnp.int32)
    orig = bases
    last_j = lengths - k                       # may be negative (short reads)
    edits = jnp.zeros(B, dtype=jnp.int32)
    done = last_j < 0                          # reads shorter than k
    BM = B * max_cands

    def apply_at_width(Q, capped, livef):
        """Evaluate + apply all live candidates, compacted to width Q.

        The flat entry list is read-major/slot-order — exactly the oracle's
        candidate-list order — so the conflict-suppression scan below sees
        each read's earlier candidates at flat offsets -1..-(max_cands-1).
        """
        def go(args):
            bases, edits, done = args
            rank = jnp.cumsum(livef.astype(jnp.int32)) - 1
            destf = jnp.where(livef, rank, Q)
            sel = jnp.full(Q + 1, BM, jnp.int32).at[destf].set(
                jnp.arange(BM, dtype=jnp.int32), mode="drop")[:Q]
            pad = sel >= BM
            selc = jnp.minimum(sel, BM - 1)
            ent_r = selc // max_cands
            ent_cc = selc % max_cands            # within-read candidate index
            ent_i = jnp.where(pad, -1, capped.reshape(-1)[selc])

            best_b, accept = _eval_entries(
                bases, lengths, last_j, ent_r, ent_i, k, solid_fn)

            # conflict suppression (DESIGN.md §8 v2): a read's candidates
            # occupy consecutive flat slots in cc order, so earlier APPLIED
            # edits of the same read sit at flat offsets 1..cc back.
            applied = accept & (ent_cc == 0)
            for p in range(1, max_cands):
                conf = jnp.zeros(Q, dtype=bool)
                for o in range(1, p + 1):
                    pr_app = jnp.concatenate(
                        [jnp.zeros(o, dtype=bool), applied[:-o]])
                    pr_r = jnp.concatenate(
                        [jnp.full(o, -1, jnp.int32), ent_r[:-o]])
                    pr_i = jnp.concatenate(
                        [jnp.full(o, -(k + 1), jnp.int32), ent_i[:-o]])
                    conf = conf | (pr_app & (pr_r == ent_r)
                                   & (jnp.abs(pr_i - ent_i) <= k - 1))
                applied = applied | (accept & (ent_cc == p) & ~conf)

            ic = jnp.clip(ent_i, 0, L - 1)
            row = jnp.where(applied, ent_r, B)   # B = dropped
            bases = bases.at[row, ic].set(best_b, mode="drop")
            edits = edits.at[row].add(1, mode="drop")
            made = jnp.zeros(B, jnp.int32).at[row].add(1, mode="drop") > 0
            done = done | ~made
            return bases, edits, done
        return go

    def round_body(args):
        bases, edits, done = args
        solid, existing = _window_counts(bases, last_j, k, solid_fn)
        all_solid = jnp.all(solid | ~existing, axis=1)
        any_solid = jnp.any(solid, axis=1)
        done = done | all_solid | ~any_solid
        active = ~done

        cands = _weak_run_candidates(solid, existing, last_j, k, max_runs)
        cands = jnp.where(active[:, None], cands, -1)

        # per-read cap: first max_cands candidates, compacted to (B, max_cands)
        # via per-slot masked-max reduces (no scatters; cands >= 0 when live)
        live_row = cands >= 0
        rr = jnp.cumsum(live_row.astype(jnp.int32), axis=1) - 1
        capped = jnp.stack(
            [jnp.max(jnp.where(live_row & (rr == s), cands, -1), axis=1)
             for s in range(max_cands)], axis=1)

        livef = (capped >= 0).reshape(-1)

        if uniform_width:
            # collective-safe: one full-width apply, no data-dependent
            # branching (see docstring)
            return apply_at_width(BM, capped, livef)((bases, edits, done))

        n_ent = jnp.sum(livef.astype(jnp.int32))
        # width dispatch: most rounds have few candidates; jit compiles all
        # widths but runtime picks the smallest sufficient one.
        ws = sorted({min(BM, max(128, B // 4)), min(BM, max(128, B)),
                     min(BM, max(128, 2 * B)), BM})
        f = apply_at_width(ws[-1], capped, livef)
        for w in reversed(ws[:-1]):
            f = (lambda fw, fbig, w: lambda a: jax.lax.cond(
                n_ent <= w, fw, fbig, a))(
                    apply_at_width(w, capped, livef), f, w)
        bases, edits, done = jax.lax.cond(
            n_ent > 0, f, lambda a: (a[0], a[1], jnp.ones_like(a[2])),
            (bases, edits, done))
        return bases, edits, done

    for _ in range(rounds):
        bases, edits, done = round_body((bases, edits, done))

    revert = edits > max_edits
    bases = jnp.where(revert[:, None], orig, bases)
    n_edits = jnp.where(revert, 0, edits)
    return bases, n_edits
