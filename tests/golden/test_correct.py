"""Golden: kmerax.ops.correct_batch vs oracle.correct_read — bit identical."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kmerax.core import canonical_words, extract_kmers
from kmerax.ops import correct_batch
from kmerax.spectrum import BloomParams, insert, make_table, query
from kmerax.spectrum.exact import mask_invalid, sort_kmers, unique_counts
from kmerax.spectrum import lookup_sorted

import oracle
from sim import ecoli_like


def _pad_batch(reads_bases, L):
    B = len(reads_bases)
    out = np.full((B, L), 4, dtype=np.int32)
    lens = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads_bases):
        out[i, :len(r)] = r
        lens[i] = len(r)
    return jnp.asarray(out), jnp.asarray(lens)


@pytest.fixture(scope="module")
def dataset():
    _, reads = ecoli_like(seed=33, genome_len=4000, coverage=45,
                          read_len=100, error_rate=0.01)
    bases = [r.bases.copy() for r in reads]
    # spice: N bases, truncated reads, a read shorter than k
    bases[3][50] = 4
    bases[7] = bases[7][:60]
    bases[11] = bases[11][:20]
    bases[13][0] = (bases[13][0] + 1) % 4      # error at pos 0
    bases[17][99] = (bases[17][99] + 2) % 4    # error at last pos
    return bases


@pytest.mark.parametrize("spectrum_kind", ["bloom", "exact"])
def test_correct_matches_oracle(dataset, spectrum_kind):
    k, t = 31, 3
    bases_list = dataset
    all_bases, lens = _pad_batch(bases_list, 100)

    if spectrum_kind == "bloom":
        params = BloomParams(k=k, log2_width=18, num_hashes=4)

        @jax.jit
        def build(b):
            words, valid = extract_kmers(b, k)
            canon, _ = canonical_words(words, k)
            return insert(params, make_table(params), canon, valid)

        table = build(all_bases)
        query_fn = lambda cw, v: query(params, table, cw, v)
        obl = oracle.CountingBloomOracle(k, log2_width=18, num_hashes=4)
        obl.add_reads(bases_list)
        oquery = obl.query
    else:
        @jax.jit
        def build(b):
            words, valid = extract_kmers(b, k)
            canon, _ = canonical_words(words, k)
            flat = mask_invalid(canon, valid).reshape(-1, canon.shape[-1])
            return unique_counts(sort_kmers(flat))

        uniq, counts, _ = build(all_bases)
        query_fn = lambda cw, v: jnp.where(
            v, lookup_sorted(uniq, counts, cw)[0], 0)
        osp = oracle.ExactSpectrum(k)
        osp.add_reads(bases_list)
        oquery = osp.query

    # device path: whole batch at once (jit)
    sub = bases_list[:160]
    b, l = _pad_batch(sub, 100)
    fixed, n_edits = jax.jit(
        lambda b, l: correct_batch(b, l, k, t, query_fn))(b, l)
    fixed = np.asarray(fixed)
    n_edits = np.asarray(n_edits)

    mismatches = 0
    total_edited = 0
    for i, r in enumerate(sub):
        want = oracle.correct_read(r, k, t, oquery)
        got = fixed[i, :len(r)]
        if not np.array_equal(got, want):
            mismatches += 1
            print(f"read {i}: oracle={want[:40]} got={got[:40]}")
        if not np.array_equal(want, r):
            total_edited += 1
        assert np.all(fixed[i, len(r):] == 4), "padding must stay 4"
    assert mismatches == 0
    assert total_edited > 20, "test should actually exercise correction"
    assert (n_edits > 0).sum() > 20


def test_correct_batch_split_invariance(dataset):
    """Same reads, different batch split -> identical output (DESIGN.md §13)."""
    k, t = 31, 3
    bases_list = dataset[:64]
    all_b, all_l = _pad_batch(bases_list, 100)
    params = BloomParams(k=k, log2_width=18, num_hashes=4)

    @jax.jit
    def build(b):
        words, valid = extract_kmers(b, k)
        canon, _ = canonical_words(words, k)
        return insert(params, make_table(params), canon, valid)

    table = build(all_b)
    qf = lambda cw, v: query(params, table, cw, v)
    f = jax.jit(lambda b, l: correct_batch(b, l, k, t, qf)[0])
    whole = np.asarray(f(all_b, all_l))
    parts = np.concatenate([np.asarray(f(all_b[:20], all_l[:20])),
                            np.asarray(f(all_b[20:], all_l[20:]))])
    assert np.array_equal(whole, parts)


def test_correct_batch_bitmap_path_identical(dataset):
    """correct_batch(solid_fn=bitmap) is bit-identical to the count path."""
    from kmerax.spectrum.bloom import query_solid, solidity_bitmap

    bases_list = dataset
    k, t = 25, 2
    params = BloomParams(k=k, log2_width=18, num_hashes=4)
    b, lengths = _pad_batch(bases_list, 100)

    @jax.jit
    def build(bases):
        words, valid = extract_kmers(bases, k)
        canon, _ = canonical_words(words, k)
        return insert(params, make_table(params), canon, valid)

    table = build(b)
    qf = lambda cw, v: query(params, table, cw, v)
    bitmap = solidity_bitmap(params, table, t)
    sf = lambda cw, v: query_solid(params, bitmap, cw, v)

    ref_b, ref_e = jax.jit(
        lambda x, l: correct_batch(x, l, k, t, qf))(b, lengths)
    got_b, got_e = jax.jit(
        lambda x, l: correct_batch(x, l, k, t, solid_fn=sf))(b, lengths)
    np.testing.assert_array_equal(np.asarray(got_b), np.asarray(ref_b))
    np.testing.assert_array_equal(np.asarray(got_e), np.asarray(ref_e))


@pytest.mark.parametrize("k", [25, 31, 63])
def test_correct_step_bitmap_matches_oracle(dataset, k):
    """The production correct step (pipeline.run.make_correct_step: packed
    solidity bitmap, int8 wire) is bit-identical to oracle.correct_read."""
    from kmerax.pipeline.run import make_correct_step

    t = 3
    params = BloomParams(k=k, log2_width=18, num_hashes=4)
    all_b, _ = _pad_batch(dataset, 100)
    words, valid = extract_kmers(all_b, k)
    canon, _ = canonical_words(words, k)
    table = insert(params, make_table(params), canon, valid)
    step, spec = make_correct_step(params, table, t, rounds=2, max_runs=8,
                                   max_edits=8)
    sub = dataset[:96]
    b, lens = _pad_batch(sub, 100)
    fixed, n_edits = step(spec, b.astype(jnp.int8), lens)
    fixed = np.asarray(fixed)
    obl = oracle.CountingBloomOracle(k, log2_width=18, num_hashes=4)
    obl.add_reads(dataset)
    for i, r in enumerate(sub):
        want = oracle.correct_read(r, k, t, obl.query)
        assert np.array_equal(fixed[i, :len(r)], want), i
    assert (np.asarray(n_edits) > 0).sum() > 10
