#!/usr/bin/env python
"""Smoke run of kmerax on one NVIDIA GPU, through the entry points a user
calls. The last line of stdout is one JSON object,
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
printed only when every phase passed; any failed phase exits non-zero.

Phases (one process holds the card throughout; nothing spawns a JAX child):
  1 device  — refuse anything but a GPU; print the card's name and power
              limit beside JAX's device kind.
  2 parity  — `kmerax pipeline --validate` (count -> correct -> assemble ->
              align) on simulated PE reads at k=31 PE150, k=25 PE100 and
              k=63; corrected FASTQ and contig FASTA byte-identical to the
              oracle/ reference.
  3 size    — `kmerax bench --acceptance 1 --scale full` (E. coli, 4.64 Mb
              at 50x PE150, k=31, ~1.55M reads, 2^29-counter Bloom), then
              config 3 (correct + unitig assembly + validate) scaled to fit
              the run's time limit.
  4 kernel  — band-align kernel vs the XLA path at B=16384, n=150,
              band=15: exact parity (and vs oracle.align on a sample),
              ms/batch of both, and the align stage (validate_batch_phased)
              with each.
  5 tests   — the `gpu`-marked pytest suite, in this process.

`--four` runs only the bucket-sharded path on four cards: acceptance
configs 4 and 5 on a 1x4 mesh, each compared byte-for-byte with the same
input on one card.

Usage:  python chip_smoke.py [--four]
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# config 3 is cut to this genome scale (x 80 kb): 2.4 Mb of the 46.7 Mb
# chr21 keeps the whole script inside its 1200 s limit
CONFIG3_SCALE = 30.0
PARITY_CASES = (            # (k, read_len, genome_len, coverage)
    (31, 150, 8_000, 40),
    (25, 100, 8_000, 50),
    (63, 150, 8_000, 40),
)


def say(msg: str) -> None:
    print(msg, flush=True)


def _cli(argv) -> dict:
    """Run `kmerax <argv>` in this process; returns its JSON result."""
    from kmerax.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"kmerax {argv[0]} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def _stage_times(workdir: str) -> dict:
    out = {}
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        for ln in f:
            rec = json.loads(ln)
            out[rec["stage"]] = out.get(rec["stage"], 0.0) + rec["wall_s"]
    return {k: round(v, 3) for k, v in out.items()}


# -- phase 2 ---------------------------------------------------------------

def _oracle_outputs(reads_by_file, k: int, lw: int):
    """Oracle corrected FASTQ bytes per file and contig FASTA text."""
    import oracle

    allr = [r.bases for rs in reads_by_file for r in rs]
    sp = oracle.ExactSpectrum(k)
    sp.add_reads(allr)
    t = oracle.auto_threshold(oracle.histogram_of(sp.sorted_items()[1]))
    obl = oracle.CountingBloomOracle(k, log2_width=lw, num_hashes=4)
    obl.add_reads(allr)
    fastqs, fixed_all = [], []
    for rs in reads_by_file:
        buf = io.BytesIO()
        for r in rs:
            fixed = oracle.correct_read(r.bases, k, t, obl.query)
            fixed_all.append(fixed)
            buf.write(f"@{r.name}\n{oracle.bases_to_seq(fixed)}\n+\n"
                      f"{r.qual}\n".encode())
        fastqs.append(buf.getvalue())
    sp2 = oracle.ExactSpectrum(k)
    sp2.add_reads(fixed_all)
    t2 = oracle.auto_threshold(oracle.histogram_of(sp2.sorted_items()[1]))
    return fastqs, oracle.assemble_fasta(sp2, t2, k), t


def phase_parity(tmp: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from sim import make_fastq, random_genome, simulate_pairs
    import numpy as np

    lw = 20
    for k, L, G, cov in PARITY_CASES:
        d = os.path.join(tmp, f"parity_k{k}")
        os.makedirs(d)
        rng = np.random.default_rng(1000 + k)
        genome = random_genome(rng, G)
        r1, r2 = simulate_pairs(genome, G * cov // (2 * L), L, 0.01,
                                seed=k, insert_mean=3 * L,
                                insert_sd=L // 4)
        ins = [os.path.join(d, f"r{i}.fastq") for i in (1, 2)]
        outs = [os.path.join(d, f"c{i}.fastq") for i in (1, 2)]
        fa = os.path.join(d, "contigs.fasta")
        for p, rs in zip(ins, (r1, r2)):
            with open(p, "wb") as f:
                f.write(make_fastq(rs))
        t0 = time.perf_counter()
        res = _cli(["pipeline", "-k", str(k), "--bloom-log2-width", str(lw),
                    "--batch-reads", "1024", "--max-read-len", str(L + 10),
                    "--exact-capacity", str(1 << 19), "--in", *ins,
                    "--out-fastq", *outs, "--out-fasta", fa, "--validate"])
        wall = time.perf_counter() - t0
        want_fq, want_fa, t = _oracle_outputs((r1, r2), k, lw)
        same_fq = all(open(o, "rb").read() == w
                      for o, w in zip(outs, want_fq))
        same_fa = open(fa, "rb").read() == want_fa.encode()
        say(f"parity k={k} PE{L}: genome {G} bp, {2 * len(r1)} reads, "
            f"threshold {res['threshold']} (oracle {t}), "
            f"{res.get('unitigs')} unitigs, validate {res.get('validate')}, "
            f"pipeline {wall:.1f} s (compile included); "
            f"fastq identical={same_fq} fasta identical={same_fa}")
        if not (same_fq and same_fa and res["threshold"] == t):
            raise AssertionError(f"k={k}: output differs from oracle/")


# -- phase 3 ---------------------------------------------------------------

def _acceptance(n: int, scale: str) -> dict:
    t0 = time.perf_counter()
    rep = _cli(["bench", "--acceptance", str(n), "--scale", scale])
    wall = time.perf_counter() - t0
    stages = _stage_times(rep["workdir"])
    shutil.rmtree(rep["workdir"], ignore_errors=True)
    say(f"config {n} ({rep['name']}): genome {rep['genome_len']} bp, "
        f"{rep['reads']} reads, mesh {rep['mesh']}, threshold "
        f"{rep['threshold']}, pipeline wall {rep['wall_s']} s "
        f"({rep['reads_per_s']} reads/s), stage wall s {stages}, "
        f"harness wall incl. simulation {wall:.1f} s")
    say(f"config {n} accuracy vs simulated truth: {rep['accuracy']}")
    for key in ("unitigs", "assembly", "validate"):
        if key in rep:
            say(f"config {n} {key}: {rep[key]}")
    say(f"config {n} peak device bytes so far: {_peak_bytes()}")
    return rep


def phase_size(scale1: str = "full",
               scale3: float = CONFIG3_SCALE) -> None:
    from kmerax.bench.acceptance import CONFIGS

    say("config 1 oracle sample: not compared at this size — the oracle's "
        "counting Bloom is pure Python and cannot count ~186M k-mers "
        "inside the run's limit; byte-identity on this code path is phase "
        "2's, and accuracy is scored against the simulated truth")
    rep = _acceptance(1, scale1)
    if rep["accuracy"]["gain"] < 0.9 or rep["accuracy"][
            "errors_introduced"] > rep["accuracy"]["errors_before"] // 1000:
        raise AssertionError(f"config 1 correction regressed: {rep}")
    spec = CONFIGS[3]
    say(f"config 3 cut: scale {scale3} -> "
        f"{int(spec.genome_len * scale3)} of "
        f"{spec.full_genome_len} bp (run time limit)")
    rep = _acceptance(3, str(scale3))
    if rep["assembly"]["genome_kmer_fraction"] < 0.99 \
            or rep["accuracy"]["gain"] < 0.9:
        raise AssertionError(f"config 3 regressed: {rep}")


# -- phase 4 ---------------------------------------------------------------

def _time_chained(fn, batches) -> float:
    import jax

    jax.block_until_ready(fn(*batches[0]))
    t0 = time.perf_counter()
    outs = [fn(*b) for b in batches[1:]]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / (len(batches) - 1) * 1e3


def phase_kernel(B: int = 16384) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import oracle
    import kmerax.ops.align as align
    from kmerax.bench.runners import bench_align
    from kmerax.config import KmeraxConfig
    from kmerax.ops.pallas_align import banded_align_scores_pallas

    n, band = 150, 15

    def batch(seed):
        rng = np.random.default_rng(seed)
        q = rng.integers(0, 4, (B, n)).astype(np.int32)
        t = np.where(rng.random((B, n)) < 0.02,
                     rng.integers(0, 5, (B, n)), q).astype(np.int32)
        ln = np.full(B, n, np.int32)
        ln[: B // 8] = rng.integers(n - 40, n + 1, B // 8)
        tl = np.clip(ln + rng.integers(-3, 4, B), 0, n).astype(np.int32)
        return tuple(map(jnp.asarray, (q, t, ln, tl)))

    batches = [batch(s) for s in range(9)]
    xla = jax.jit(lambda *a: align.banded_align_scores(*a, band))
    ker = jax.jit(lambda *a: banded_align_scores_pallas(*a, band))
    ref, got = np.asarray(xla(*batches[0])), np.asarray(ker(*batches[0]))
    same = bool(np.array_equal(ref, got))
    q, t, ln, tl = (np.asarray(a) for a in batches[0])
    osame = all(oracle.banded_align(q[i, :ln[i]], t[i, :tl[i]], band)[0]
                == int(got[i]) for i in range(0, B, B // 64))
    say(f"band kernel parity at B={B} n={n} band={band}: vs XLA "
        f"identical={same}; vs oracle.align (64 reads) identical={osame}")
    if not (same and osame):
        raise AssertionError("band kernel differs from the XLA path/oracle")
    times = []
    for name, fn in (("kernel", ker), ("xla", xla), ("kernel", ker),
                     ("xla", xla)):
        times.append((name, _time_chained(fn, batches)))
    say(f"band DP ms/batch (B={B}, chained 8 batches, one sync): {times}")

    cfg = KmeraxConfig(k=31)
    stage = []
    for name in ("kernel", "xla", "kernel", "xla"):
        saved = align.band_scores
        if name == "xla":
            align.band_scores = align.banded_align_scores
        try:
            r = bench_align(cfg, n_reads=B)
        finally:
            align.band_scores = saved
        stage.append((name, B / r["value"] * 1e3, r["value"]))
    say(f"align stage validate_batch_phased (ms/batch, reads/s) at "
        f"B={B}: {stage}")
    best = {p: min(ms for n_, ms, _ in stage if n_ == p)
            for p in ("kernel", "xla")}
    say(f"align stage with the kernel faster than with XLA: "
        f"{best['kernel'] < best['xla']} ({best})")


# -- phase 5 ---------------------------------------------------------------

def phase_tests() -> None:
    import pytest

    class Count:
        def __init__(self):
            self.passed = self.other = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other += 1

    c = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "gpu")], plugins=[c])
    say(f"gpu-marked tests: {c.passed} passed, {c.other} failed or "
        f"skipped, pytest exit {rc}")
    if rc != 0 or c.passed == 0 or c.other:
        raise AssertionError("gpu-marked tests did not all pass")


# -- --four ----------------------------------------------------------------

def phase_four(tmp: str) -> None:
    from kmerax.bench.acceptance import run_config

    def outputs(workdir):
        return {f: open(os.path.join(workdir, f), "rb").read()
                for f in sorted(os.listdir(workdir))
                if f.startswith("corrected_") or f == "contigs.fasta"}

    for n in (4, 5):
        reps = {}
        for mesh in ((1, 1), (1, 4)):
            wd = os.path.join(tmp, f"c{n}_{mesh[0]}x{mesh[1]}")
            rep = run_config(n, scale="1.0", workdir=wd, overrides={
                "mesh_data": mesh[0], "mesh_bucket": mesh[1]})
            reps[mesh] = (rep, outputs(wd))
            say(f"config {n} mesh {rep['mesh']}: {rep['reads']} reads, "
                f"wall {rep['wall_s']} s, threshold {rep.get('threshold')}, "
                f"gain {rep['accuracy']['gain']}, "
                f"unitigs {rep.get('unitigs')}, files "
                f"{sorted(reps[mesh][1])}")
        one, four = reps[(1, 1)][1], reps[(1, 4)][1]
        same = one.keys() == four.keys() and all(
            one[f] == four[f] for f in one)
        say(f"config {n}: 1x4 mesh outputs byte-identical to one card: "
            f"{same}")
        if not same or not one:
            raise AssertionError(f"config {n}: sharded run differs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only configs 4-5 bucket-sharded on 4 cards "
                         "against one card")
    args = ap.parse_args(argv)

    from kmerax.bench.device import card_name_power, require_gpu

    device = require_gpu()
    say(f"device: {device['platform']} {device['kind']} "
        f"x{device['count']}")
    say(f"card (name, power limit): {card_name_power()}")
    from kmerax.utils.compile_cache import enable

    say(f"compile cache: {enable()}")
    if args.four and device["count"] < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {device['count']}")

    tmp = tempfile.mkdtemp(prefix="kmerax_smoke_")
    phases = ([("four", lambda: phase_four(tmp))] if args.four else
              [("parity", lambda: phase_parity(tmp)),
               ("size", phase_size),
               ("kernel", phase_kernel),
               ("tests", phase_tests)])
    failed = []
    t_all = time.perf_counter()
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            say(f"== phase {name}")
            try:
                fn()
            except Exception:  # report every phase, then fail the run
                traceback.print_exc()
                failed.append(name)
            say(f"== phase {name}: {'FAILED' if name in failed else 'ok'} "
                f"in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"total {time.perf_counter() - t_all:.1f} s; failed phases: "
        f"{failed or 'none'}")
    if failed:
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
