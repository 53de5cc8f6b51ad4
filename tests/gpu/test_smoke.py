"""Parity on the GPU (SURVEY.md §4.4): the compiled device paths agree
bit-for-bit with the oracle and with the XLA references. Marked `gpu`;
the `gpu_device` fixture skips them where JAX finds no GPU. Run with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/gpu
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_count_numerics_vs_oracle(gpu_device):
    """Device count step produces the oracle Bloom table bit-for-bit."""
    import jax
    import jax.numpy as jnp
    import oracle
    from kmerax.config import KmeraxConfig
    from kmerax.core import canonical_words, extract_kmers
    from kmerax.pipeline.run import _bloom_params
    from kmerax.spectrum.bloom import insert, make_table

    rng = np.random.default_rng(0)
    reads = rng.integers(0, 4, (64, 100)).astype(np.int32)
    params = _bloom_params(KmeraxConfig(k=31, bloom_log2_width=16), 31)

    @jax.jit
    def step(t, b):
        w, v = extract_kmers(b, 31)
        c, _ = canonical_words(w, 31)
        return insert(params, t, c, v)

    table = np.asarray(step(make_table(params), jnp.asarray(reads)))
    obl = oracle.CountingBloomOracle(31, log2_width=16, num_hashes=4)
    obl.add_reads([r.astype(np.uint8) for r in reads])
    assert np.array_equal(table, obl.table.astype(np.int32))


def test_p16_insert_query_matches_i32_compiled(gpu_device):
    """Compiled p16 packed-counter parity: the unpacked table equals the
    i32 table, and the p16 solidity bitmap query equals query(i32) >= t."""
    import dataclasses
    import functools
    import jax
    import jax.numpy as jnp
    from kmerax.config import KmeraxConfig
    from kmerax.core import canonical_words, extract_kmers
    from kmerax.pipeline.run import _bloom_params
    from kmerax.spectrum.bloom import (
        insert, make_table, query, query_solid, solidity_bitmap, unpack16,
    )
    from kmerax.bench.runners import _sim_batch

    p16 = _bloom_params(
        KmeraxConfig(k=31, bloom_log2_width=20, bloom_counter="p16"), 31)
    i32 = dataclasses.replace(p16, counter="i32")
    reads = jnp.asarray(_sim_batch(512, 150, seed=5, genome_len=1 << 14))

    def build(p, t, b):
        w, v = extract_kmers(b, 31)
        c, _ = canonical_words(w, 31)
        return insert(p, t, c, v)

    t16 = jax.jit(functools.partial(build, p16))(make_table(p16), reads)
    t32 = jax.jit(functools.partial(build, i32))(make_table(i32), reads)
    assert np.array_equal(np.asarray(unpack16(t16)), np.asarray(t32))

    w, v = extract_kmers(reads, 31)
    c, _ = canonical_words(w, 31)
    ref = np.asarray(jax.jit(lambda: (query(i32, t32, c, v) >= 3) & v)())
    got = np.asarray(jax.jit(lambda: query_solid(
        p16, solidity_bitmap(p16, t16, 3), c, v))())
    assert np.array_equal(ref, got)


def test_band_kernel_matches_xla(gpu_device):
    """The compiled band-align kernel agrees bit-for-bit with the XLA
    max-plus path, edge lengths included."""
    import jax
    import jax.numpy as jnp
    from kmerax.ops.align import banded_align_scores
    from kmerax.ops.pallas_align import banded_align_scores_pallas

    rng = np.random.default_rng(3)
    B, n, band = 1000, 150, 15
    q = rng.integers(0, 5, (B, n)).astype(np.int32)
    t = np.where(rng.random((B, n)) < 0.05,
                 rng.integers(0, 4, (B, n)), q).astype(np.int32)
    qlen = rng.integers(0, n + 1, B).astype(np.int32)
    tlen = np.clip(qlen + rng.integers(-band - 2, band + 3, B), 0,
                   n).astype(np.int32)
    qlen[:3] = (0, n, n)
    tlen[:3] = (0, 0, n)
    args = tuple(map(jnp.asarray, (q, t, qlen, tlen)))
    ref = np.asarray(jax.jit(
        lambda *a: banded_align_scores(*a, band))(*args))
    got = np.asarray(jax.jit(
        lambda *a: banded_align_scores_pallas(*a, band))(*args))
    assert np.array_equal(ref, got)


def test_correct_batch_vs_oracle_compiled(gpu_device):
    """The production correct step (bitmap spectrum) on the device equals
    oracle.correct_read read by read."""
    import jax.numpy as jnp
    import oracle
    from kmerax.core import canonical_words, extract_kmers
    from kmerax.pipeline.run import make_correct_step
    from kmerax.spectrum.bloom import BloomParams, insert, make_table

    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 3000 - 100, 512)
    reads = genome[starts[:, None] + np.arange(100)[None, :]]
    errs = rng.random(reads.shape) < 0.01
    reads = np.where(errs, (reads + 1) % 4, reads).astype(np.int32)
    params = BloomParams(k=31, log2_width=18)
    w, v = extract_kmers(jnp.asarray(reads), 31)
    c, _ = canonical_words(w, 31)
    table = insert(params, make_table(params), c, v)
    step, spec = make_correct_step(params, table, 3, rounds=2, max_runs=8,
                                   max_edits=8)
    fixed, _ = step(spec, jnp.asarray(reads.astype(np.int8)),
                    jnp.full(512, 100, jnp.int32))
    fixed = np.asarray(fixed)
    obl = oracle.CountingBloomOracle(31, log2_width=18, num_hashes=4)
    obl.add_reads([r.astype(np.uint8) for r in reads])
    for i in range(0, 512, 7):
        want = oracle.correct_read(reads[i].astype(np.uint8), 31, 3,
                                   obl.query)
        assert np.array_equal(fixed[i].astype(np.uint8), want), i
