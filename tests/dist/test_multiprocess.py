"""2-process jax.distributed count on CPU — the cross-host path
of BASELINE.md config 4: sharded spectrum across 2 'hosts', merged counts
identical to the single-process result."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_count_matches_single(tmp_path):
    here = os.path.dirname(__file__)
    worker = os.path.join(here, "_mp_worker.py")
    coord = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, "2", str(pid), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"worker {pid} OK" in out

    # single-process reference (mesh invariance: 1x1 == 2x4 across hosts)
    import jax
    from kmerax.config import KmeraxConfig
    from kmerax.core import canonical_words, extract_kmers
    from kmerax.pipeline.run import _bloom_params
    from kmerax.spectrum.bloom import insert, make_table
    from sim import ecoli_like
    import jax.numpy as jnp

    got = np.load(tmp_path / "mp_result.npz")
    _, reads = ecoli_like(seed=202, genome_len=1000, coverage=20,
                          read_len=100, error_rate=0.01)
    n = int(got["n_reads"])
    bases = jnp.asarray(
        np.stack([r.bases for r in reads[:n]]).astype(np.int32))
    params = _bloom_params(KmeraxConfig(k=31, bloom_log2_width=16), 31)

    @jax.jit
    def ref(b):
        words, valid = extract_kmers(b, 31)
        canon, _ = canonical_words(words, 31)
        return insert(params, make_table(params), canon, valid)

    want = np.asarray(ref(bases))
    assert int(got["nk"]) == int((np.asarray(want)).sum() // 4)
    assert np.array_equal(got["table"], want), \
        "2-process merged table != single-process table"


def test_two_process_pipeline_byte_identical(tmp_path):
    """PRODUCTION `kmerax pipeline` on 2 processes (2x4 mesh): corrected
    FASTQ + contig FASTA byte-identical to the single-process 1x1 run
    (DESIGN.md §13 mesh invariance, through the real CLI entry point)."""
    from sim import ecoli_like, make_fastq

    _, reads = ecoli_like(seed=77, genome_len=3000, coverage=40,
                          read_len=100, error_rate=0.01)
    fastq = tmp_path / "in.fastq"
    fastq.write_bytes(make_fastq(reads))

    here = os.path.dirname(__file__)
    worker = os.path.join(here, "_mp_pipeline_worker.py")
    coord = f"localhost:{_free_port()}"
    # shared outdir (the shared-FS contract: assemble re-reads the
    # corrected FASTQ on every host; only process 0 writes)
    outdir = tmp_path / "out"
    outdir.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, "2", str(pid), str(outdir),
         str(fastq)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"worker {pid} OK" in out

    assert (outdir / "corrected.fastq").exists()

    # single-process reference through the same production entry point
    from kmerax.config import KmeraxConfig
    from kmerax.pipeline import run_pipeline

    cfg = KmeraxConfig(k=31, bloom_log2_width=16, batch_reads=512,
                       max_read_len=100, exact_capacity=1 << 16)
    ref_fq = tmp_path / "ref.fastq"
    ref_fa = tmp_path / "ref.fasta"
    run_pipeline(cfg, [str(fastq)], str(ref_fq), out_fasta=str(ref_fa))

    assert (outdir / "corrected.fastq").read_bytes() == \
        ref_fq.read_bytes(), "multi-host corrected FASTQ differs"
    assert (outdir / "contigs.fasta").read_bytes() == \
        ref_fa.read_bytes(), "multi-host contig FASTA differs"
