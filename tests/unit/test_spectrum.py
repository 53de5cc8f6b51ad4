"""kmerax.spectrum vs oracle: Bloom, exact sort+segment-sum, histogram."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kmerax.core import canonical_words, extract_kmers
from kmerax.spectrum import (
    BloomParams, insert, make_table, query,
    merge_sorted, lookup_sorted, sort_kmers, unique_counts,
)
from kmerax.spectrum.exact import mask_invalid, is_sentinel
from kmerax.spectrum.histogram import count_histogram, solid_threshold

import oracle
from oracle.codec import int_to_words, num_words, words_to_int
from sim import ecoli_like


def _batch(reads):
    return jnp.asarray(np.stack([r if isinstance(r, np.ndarray) else r.bases
                                 for r in reads]).astype(np.int32))


@pytest.fixture(scope="module")
def dataset():
    genome, reads = ecoli_like(seed=21, genome_len=3000, coverage=30,
                               read_len=100, error_rate=0.01)
    return genome, reads


@pytest.mark.parametrize("k,scheme", [(25, "hash"), (31, "hash"),
                                      (31, "minimizer")])
def test_bloom_matches_oracle(dataset, k, scheme):
    _, reads = dataset
    reads = reads[:300]
    params = BloomParams(k=k, log2_width=18, num_hashes=4,
                         bucket_scheme=scheme)
    bases = _batch(reads)

    @jax.jit
    def build(bases):
        words, valid = extract_kmers(bases, k)
        canon, _ = canonical_words(words, k)
        t = insert(params, make_table(params), canon, valid)
        return t, query(params, t, canon, valid)

    table, counts = build(bases)
    obl = oracle.CountingBloomOracle(k, log2_width=18, num_hashes=4,
                                     bucket_scheme=scheme)
    obl.add_reads([r.bases for r in reads])
    assert int(np.asarray(table).sum()) == int(obl.table.sum())
    counts = np.asarray(counts)
    for b in range(0, len(reads), 37):
        for j, c in oracle.read_kmers(reads[b].bases, k):
            assert int(counts[b, j]) == obl.query(c)


def test_bloom_insert_split_batches_equals_one(dataset):
    _, reads = dataset
    k = 31
    params = BloomParams(k=k, log2_width=16, num_hashes=4)
    bases = _batch(reads[:200])

    @jax.jit
    def ins(t, b):
        words, valid = extract_kmers(b, k)
        canon, _ = canonical_words(words, k)
        return insert(params, t, canon, valid)

    t_one = ins(make_table(params), bases)
    t_two = ins(ins(make_table(params), bases[:90]), bases[90:])
    assert np.array_equal(np.asarray(t_one), np.asarray(t_two))


@pytest.mark.parametrize("k", [31, 63])
def test_exact_unique_counts_vs_oracle(dataset, k):
    _, reads = dataset
    reads = reads[:200]
    bases = _batch(reads)

    @jax.jit
    def count(bases):
        words, valid = extract_kmers(bases, k)
        canon, _ = canonical_words(words, k)
        flat = mask_invalid(canon, valid).reshape(-1, canon.shape[-1])
        return unique_counts(sort_kmers(flat))

    uniq, counts, n = count(bases)
    sp = oracle.ExactSpectrum(k)
    sp.add_reads([r.bases for r in reads])
    keys, ocounts = sp.sorted_items()
    n = int(n)
    assert n == len(keys)
    uniq, counts = np.asarray(uniq), np.asarray(counts)
    w = num_words(k)
    for i in range(n):
        assert words_to_int(uniq[i]) == keys[i]
        assert int(counts[i]) == ocounts[i]
    assert is_sentinel(jnp.asarray(uniq[n:])).all()


def test_merge_sorted_equals_single_pass(dataset):
    _, reads = dataset
    k = 31
    bases = _batch(reads[:120])

    def spectrum(b):
        words, valid = extract_kmers(b, k)
        canon, _ = canonical_words(words, k)
        flat = mask_invalid(canon, valid).reshape(-1, canon.shape[-1])
        return unique_counts(sort_kmers(flat))

    u_all, c_all, n_all = jax.jit(spectrum)(bases)
    u1, c1, n1 = jax.jit(spectrum)(bases[:50])
    u2, c2, n2 = jax.jit(spectrum)(bases[50:])
    um, cm, nm = jax.jit(merge_sorted)(u1, c1, u2, c2)
    assert int(nm) == int(n_all)
    n = int(n_all)
    assert np.array_equal(np.asarray(um)[:n], np.asarray(u_all)[:n])
    assert np.array_equal(np.asarray(cm)[:n], np.asarray(c_all)[:n])


def test_lookup_sorted(dataset):
    _, reads = dataset
    k = 31
    bases = _batch(reads[:100])
    words, valid = extract_kmers(bases, k)
    canon, _ = canonical_words(words, k)
    flat = mask_invalid(canon, valid).reshape(-1, canon.shape[-1])
    uniq, counts, n = jax.jit(lambda f: unique_counts(sort_kmers(f)))(flat)
    got, found = jax.jit(lookup_sorted)(uniq, counts, canon)
    got = np.asarray(got)
    sp = oracle.ExactSpectrum(k)
    sp.add_reads([r.bases for r in reads[:100]])
    for b in range(0, 100, 17):
        for j, c in oracle.read_kmers(reads[b].bases, k):
            assert int(got[b, j]) == sp.query(c)
    # a k-mer not in the spectrum
    probe = jnp.asarray(np.array([int_to_words(
        (1 << 62) - 12345, num_words(k))], dtype=np.uint32))
    cq, fq = lookup_sorted(uniq, counts, probe)
    assert int(cq[0]) == 0 and not bool(fq[0])


def test_histogram_threshold_vs_oracle(dataset):
    _, reads = dataset
    k = 31
    bases = _batch(reads)
    words, valid = extract_kmers(bases, k)
    canon, _ = canonical_words(words, k)
    flat = mask_invalid(canon, valid).reshape(-1, canon.shape[-1])
    uniq, counts, n = jax.jit(lambda f: unique_counts(sort_kmers(f)))(flat)
    hist = np.asarray(count_histogram(counts))
    sp = oracle.ExactSpectrum(k)
    sp.add_reads([r.bases for r in reads])
    ohist = oracle.histogram_of(sp.sorted_items()[1])
    assert np.array_equal(hist[1:], ohist[1:])
    assert solid_threshold(hist) == oracle.auto_threshold(ohist)
    assert solid_threshold(hist, override=5) == 5


def test_solidity_bitmap_matches_thresholded_query(dataset):
    """query_solid(bitmap) == (query(table) >= t) for every window & t."""
    from kmerax.spectrum.bloom import query_solid, solidity_bitmap

    _, reads = dataset
    k = 31
    params = BloomParams(k=k, log2_width=16, num_hashes=4)
    bases = _batch(reads[:200])

    @jax.jit
    def build(bases):
        words, valid = extract_kmers(bases, k)
        canon, _ = canonical_words(words, k)
        table = insert(params, make_table(params), canon, valid)
        return table, canon, valid

    table, canon, valid = build(bases)
    for t in (1, 2, 3, 7):
        bitmap = solidity_bitmap(params, table, t)
        assert bitmap.dtype == jnp.uint32
        assert bitmap.shape == (params.width // 32,)
        want = (np.asarray(query(params, table, canon, valid)) >= t) \
            & np.asarray(valid)
        got = np.asarray(query_solid(params, bitmap, canon, valid))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scheme", ["hash", "minimizer"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_range_shard_insert_matches_oracle(dataset, scheme, n_shards):
    """Each range shard (local_bits, DESIGN.md §12) fed only the k-mers it
    owns equals its slice of the oracle's global table, both schemes."""
    from kmerax.spectrum.bloom import probe_indices

    _, reads = dataset
    reads = reads[:150]
    k, lw = 31, 16
    params = BloomParams(k=k, log2_width=lw, num_hashes=4,
                         bucket_scheme=scheme)
    local_bits = lw - (n_shards - 1).bit_length()
    words, valid = extract_kmers(_batch(reads), k)
    canon, _ = canonical_words(words, k)
    owner = probe_indices(params, canon)[..., 0] >> local_bits
    obl = oracle.CountingBloomOracle(k, log2_width=lw, num_hashes=4,
                                     bucket_scheme=scheme)
    obl.add_reads([r.bases for r in reads])
    for s in range(n_shards):
        shard = insert(params, jnp.zeros(1 << local_bits, jnp.int32), canon,
                       valid & (owner == s), local_bits=local_bits)
        want = obl.table[s << local_bits:(s + 1) << local_bits]
        assert np.array_equal(np.asarray(shard), want.astype(np.int32))
        assert int(np.asarray(shard).sum()) > 0
