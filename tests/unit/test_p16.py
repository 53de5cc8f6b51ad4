"""p16 packed-halfword counters (two saturating 16-bit counters per int32
word) vs the i32 reference. Solidity must be
identical for any threshold <= SAT16; raw counts identical below
saturation; saturation is batch-order-independent."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kmerax.core import canonical_words, extract_kmers
from kmerax.spectrum.bloom import (
    SAT16, BloomParams, insert, make_table, pack16, query, solidity_bitmap,
    query_solid, unpack16,
)

P16 = BloomParams(31, 12, 4, 11, 5, "hash", counter="p16")
I32 = dataclasses.replace(P16, counter="i32")


def _kmers(seed, n=64, L=100):
    rng = np.random.default_rng(seed)
    reads = jnp.asarray(rng.integers(0, 4, (n, L)).astype(np.int32))
    words, valid = extract_kmers(reads, 31)
    canon, _ = canonical_words(words, 31)
    return canon, valid


def test_pack_roundtrip():
    rng = np.random.default_rng(0)
    t = jnp.asarray(rng.integers(0, SAT16 + 1, 1 << 12).astype(np.int32))
    assert np.array_equal(np.asarray(unpack16(pack16(t))), np.asarray(t))


def test_insert_query_matches_i32():
    canon, valid = _kmers(1)
    t16 = insert(P16, make_table(P16), canon, valid)
    t32 = insert(I32, make_table(I32), canon, valid)
    assert t16.shape[0] == t32.shape[0] // 2
    assert np.array_equal(np.asarray(unpack16(t16)), np.asarray(t32))
    q16 = np.asarray(query(P16, t16, canon, valid))
    q32 = np.asarray(query(I32, t32, canon, valid))
    assert np.array_equal(q16, q32)
    for t in (1, 2, 5):
        bm16 = solidity_bitmap(P16, t16, t)
        bm32 = solidity_bitmap(I32, t32, t)
        assert np.array_equal(np.asarray(bm16), np.asarray(bm32))
        s16 = np.asarray(query_solid(P16, bm16, canon, valid))
        s32 = np.asarray(query_solid(I32, bm32, canon, valid))
        assert np.array_equal(s16, s32)


def test_saturation_order_independent():
    """min(sum, SAT16) whatever the batch split: hammer one k-mer far past
    SAT16 in different splits and compare tables."""
    canon, valid = _kmers(2, n=1, L=40)
    one = canon[:, :1], valid[:, :1]

    def hammer(splits):
        t = make_table(P16)
        for n in splits:
            c = jnp.repeat(one[0], n, axis=1)
            v = jnp.repeat(one[1], n, axis=1)
            t = insert(P16, t, c, v)
        return np.asarray(unpack16(t))

    total = 40000  # > SAT16
    a = hammer([total])
    b = hammer([1000] * 40)
    assert np.array_equal(a, b)
    assert a.max() == SAT16


@pytest.mark.parametrize("scheme", ["hash", "minimizer"])
def test_query_solid_matches_thresholded_query_p16(scheme):
    """p16 solidity bitmap query == query(p16) >= t, invalid lanes False."""
    p16 = dataclasses.replace(P16, bucket_scheme=scheme)
    canon, valid = _kmers(3)
    valid = valid & (jnp.arange(valid.shape[1])[None, :] % 11 != 4)
    table = insert(p16, make_table(p16), canon, valid)
    for t in (1, 2, 3):
        want = np.asarray(query(p16, table, canon, valid) >= t) & np.asarray(
            valid)
        got = np.asarray(query_solid(p16, solidity_bitmap(p16, table, t),
                                     canon, valid))
        assert np.array_equal(want, got)
    assert want.any()


def test_auto_counter_resolution():
    """"auto" resolves to i32 at every width and mesh; explicit wins."""
    from kmerax.config import KmeraxConfig
    from kmerax.pipeline.run import _bloom_params

    for lw in (20, 24, 25, 28):
        assert _bloom_params(KmeraxConfig(k=31, bloom_log2_width=lw),
                             31).counter == "i32"
    assert _bloom_params(
        KmeraxConfig(k=31, bloom_log2_width=25, mesh_data=2, mesh_bucket=4),
        31).counter == "i32"
    assert _bloom_params(
        KmeraxConfig(k=31, bloom_log2_width=25, bloom_counter="p16"),
        31).counter == "p16"
    assert _bloom_params(
        KmeraxConfig(k=31, bloom_log2_width=25, bloom_counter="i32"),
        31).counter == "i32"


def test_correct_batch_identical_with_p16():
    """End-to-end correction solidity is unchanged by the counter format."""
    from kmerax.ops.correct import correct_batch

    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 2000).astype(np.uint8)
    starts = rng.integers(0, 2000 - 80, 256)
    reads = genome[starts[:, None] + np.arange(80)[None, :]]
    errs = rng.random(reads.shape) < 0.01
    reads = np.where(errs, (reads + 1) % 4, reads).astype(np.int32)
    bases = jnp.asarray(reads)
    lengths = jnp.full(256, 80, jnp.int32)
    words, valid = extract_kmers(bases, 31)
    canon, _ = canonical_words(words, 31)

    outs = []
    for p in (I32, P16):
        table = insert(p, make_table(p), canon, valid)
        qf = lambda cw, v, p=p, table=table: query(p, table, cw, v)
        fixed, ne = correct_batch(bases, lengths, 31, 2, qf, rounds=2)
        outs.append((np.asarray(fixed), np.asarray(ne)))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])
