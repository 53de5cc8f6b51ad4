"""Band-align kernel (Pallas, Triton route) vs the XLA max-plus path
(itself golden-pinned vs oracle.align in tests/golden/test_align.py), in
interpret mode on the CPU; the compiled parity on the GPU lives in
tests/gpu/test_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest

from kmerax.ops.align import NEG_INF, banded_align_scores
from kmerax.ops.pallas_align import banded_align_scores_pallas


def _case(rng, B, n, band, mutate=0.05):
    q = rng.integers(0, 5, (B, n)).astype(np.int32)
    t = np.where(rng.random((B, n)) < mutate,
                 rng.integers(0, 4, (B, n)), q).astype(np.int32)
    qlen = rng.integers(0, n + 1, B).astype(np.int32)
    tlen = rng.integers(0, n + 1, B).astype(np.int32)
    return q, t, qlen, tlen


@pytest.mark.parametrize("band,n,B", [(15, 150, 48), (8, 64, 16),
                                      (31, 100, 8), (3, 24, 130)])
def test_pallas_matches_xla(band, n, B):
    rng = np.random.default_rng(band * 1000 + n)
    q, t, qlen, tlen = _case(rng, B, n, band)
    # force edge rows: empty query/target, equal lengths, full length
    qlen[0] = 0
    tlen[1] = 0
    qlen[2] = tlen[2] = n
    args = tuple(map(jnp.asarray, (q, t, qlen, tlen)))
    ref = np.asarray(banded_align_scores(*args, band))
    got = np.asarray(banded_align_scores_pallas(*args, band,
                                                interpret=True))
    assert np.array_equal(ref, got)


def test_unaligned_pairs_get_neg_inf():
    rng = np.random.default_rng(7)
    band, n, B = 5, 40, 16
    q, t, qlen, tlen = _case(rng, B, n, band, mutate=1.0)
    qlen[:] = n
    tlen[:] = rng.integers(0, n - band - 1, B)  # |tlen-qlen| > band
    args = tuple(map(jnp.asarray, (q, t, qlen, tlen)))
    got = np.asarray(banded_align_scores_pallas(*args, band,
                                                interpret=True))
    assert np.all(got == NEG_INF)


def test_related_reads_score_positive():
    rng = np.random.default_rng(11)
    band, n, B = 15, 150, 32
    q = rng.integers(0, 4, (B, n)).astype(np.int32)
    t = q.copy()
    lens = np.full(B, n, np.int32)
    args = tuple(map(jnp.asarray, (q, t, lens, lens)))
    ref = np.asarray(banded_align_scores(*args, band))
    got = np.asarray(banded_align_scores_pallas(*args, band,
                                                interpret=True))
    assert np.array_equal(ref, got)
    assert np.all(got == 2 * n)     # perfect match: MATCH * n


@pytest.mark.parametrize("backend,kernel", [("gpu", True), ("cpu", False)])
def test_band_scores_picks_kernel_on_gpu(backend, kernel, monkeypatch):
    """ops.align.band_scores: the kernel on the GPU, XLA elsewhere."""
    import jax

    import kmerax.ops.align as align
    import kmerax.ops.pallas_align as pa

    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(pa, "banded_align_scores_pallas",
                        lambda *a: calls.append("kernel") or "k")
    monkeypatch.setattr(align, "banded_align_scores",
                        lambda *a: calls.append("xla") or "x")
    out = align.band_scores(None, None, None, None, 15)
    assert calls == (["kernel"] if kernel else ["xla"])
    assert out == ("k" if kernel else "x")
