"""Runnable acceptance matrix (BASELINE.md configs 1-5; BASELINE.json:7-11).

Each config simulates a seeded scale-down of its dataset (tests/sim.py
generator semantics, DNBSEQ-like names), writes real FASTQ(.gz) inputs,
runs the exact CLI-level pipeline stages, and reports wall time, reads/s,
and correction accuracy (the simulator knows the true bases, so we can
measure how many injected substitution errors the spectrum corrector
removed vs introduced).

`scale` multiplies the genome length; coverage/read-len/k match the spec.
Full-size parameters are recorded in CONFIGS for when real data and
multi-host slices are available.
"""

from __future__ import annotations

import gzip
import os
import time
from dataclasses import dataclass, field

import numpy as np

from kmerax.config import KmeraxConfig


@dataclass(frozen=True)
class AcceptanceSpec:
    name: str
    genome_len: int           # scale-down base length (scale=1.0)
    full_genome_len: int      # real dataset size (for the record)
    coverage: int
    read_len: int
    k: int
    k2: int = 0               # two-pass second k (config 5)
    paired: bool = True
    error_rate: float = 0.01
    assemble: bool = False
    mesh: tuple = (1, 1)      # (data, bucket); needs data*bucket devices
    note: str = ""


CONFIGS = {
    1: AcceptanceSpec(
        "ecoli_k12_pe150_50x_k31", genome_len=60_000,
        full_genome_len=4_641_652, coverage=50, read_len=150, k=31,
        note="E. coli K-12 MG1655 PE150 ~50x, k=31 count+correct "
             "(BASELINE.json:7; CPU single host)"),
    2: AcceptanceSpec(
        "scerevisiae_pe100_80x_k25", genome_len=60_000,
        full_genome_len=12_157_105, coverage=80, read_len=100, k=25,
        note="S. cerevisiae PE100 ~80x, k=25 count+correct, 1 chip "
             "(BASELINE.json:8)"),
    3: AcceptanceSpec(
        "chr21_pe150_30x_k31_assemble", genome_len=80_000,
        full_genome_len=46_709_983, coverage=30, read_len=150, k=31,
        assemble=True, error_rate=0.005,
        note="Human chr21 PE150 30x DNBSEQ-like, k=31 correct+assemble "
             "(BASELINE.json:9; single host)"),
    4: AcceptanceSpec(
        "celegans_60x_sharded_2host", genome_len=60_000,
        full_genome_len=100_286_401, coverage=60, read_len=100, k=31,
        mesh=(2, 2),
        note="C. elegans 60x, spectrum sharded over a 2x2 mesh standing in "
             "for 2 hosts, merged counts (BASELINE.json:10)"),
    5: AcceptanceSpec(
        "human_wgs_30x_twopass_k31_k63", genome_len=80_000,
        full_genome_len=3_100_000_000, coverage=30, read_len=150,
        k=31, k2=63, assemble=True, error_rate=0.005,
        note="Human WGS 30x PE150, k=31+k=63 two-pass correct+assemble "
             "(BASELINE.json:11; scaled down)"),
}


def _sim():
    """The read simulator (tests/sim.py), imported as `sim` the way the
    tests import it."""
    import importlib
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for p in (root, os.path.join(root, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    return importlib.import_module("sim")


def _write_fastq_gz(path: str, reads) -> None:
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(_sim().make_fastq(reads))


def _sim_inputs(spec: AcceptanceSpec, scale: float, workdir: str, seed: int):
    sim = _sim()
    random_genome, simulate_pairs, simulate_reads = (
        sim.random_genome, sim.simulate_pairs, sim.simulate_reads)

    g_len = max(4 * spec.read_len, int(spec.genome_len * scale))
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, g_len)
    n_reads = g_len * spec.coverage // spec.read_len
    if spec.paired:
        r1, r2 = simulate_pairs(genome, n_reads // 2, spec.read_len,
                                spec.error_rate, seed=seed + 1,
                                insert_mean=min(3 * spec.read_len, g_len),
                                insert_sd=spec.read_len // 4)
        p1 = os.path.join(workdir, "reads_1.fastq.gz")
        p2 = os.path.join(workdir, "reads_2.fastq.gz")
        _write_fastq_gz(p1, r1)
        _write_fastq_gz(p2, r2)
        return genome, [p1, p2], [r1, r2]
    reads = simulate_reads(genome, n_reads, spec.read_len, spec.error_rate,
                           seed=seed + 1)
    p = os.path.join(workdir, "reads.fastq.gz")
    _write_fastq_gz(p, reads)
    return genome, [p], [reads]


def assembly_metrics(genome: np.ndarray, fasta_path: str, k: int) -> dict:
    """Assembly quality vs the known simulated genome (round-4 VERDICT
    Weak #6: make "unitigs: N" interpretable): contig count, total bases,
    N50, and the fraction of the genome's distinct canonical k-mers that
    appear in the contigs (a gap-free coverage proxy robust to the
    orientation/offset freedom of unitigs)."""
    from kmerax.io.fasta import read_fasta
    from kmerax.ops.align import build_contig_index
    from kmerax.spectrum.host import pack_rows
    from oracle.codec import seq_to_bases

    contigs = []
    lens = []
    for _, seq in read_fasta(fasta_path):
        lens.append(len(seq))
        contigs.append(seq_to_bases(seq))
    lens.sort(reverse=True)
    total = int(sum(lens))
    n50 = 0
    acc = 0
    for ln in lens:
        acc += ln
        if acc * 2 >= total:
            n50 = ln
            break
    _, g_uniq, _ = build_contig_index([genome.astype(np.uint8)], k)
    g_keys = pack_rows(np.asarray(g_uniq))
    if contigs:
        _, c_uniq, _ = build_contig_index(contigs, k)
        c_keys = pack_rows(np.asarray(c_uniq))
    else:
        c_keys = np.zeros(0, g_keys.dtype)
    if g_keys.ndim == 2:            # k=63: (N, 2) uint64 -> void rows
        vt = [("a", np.uint64), ("b", np.uint64)]
        g_keys = np.ascontiguousarray(g_keys).view(vt).reshape(-1)
        c_keys = np.ascontiguousarray(c_keys).view(vt).reshape(-1) \
            if len(c_keys) else np.zeros(0, vt)
    covered = np.isin(g_keys, c_keys).sum()
    return {"contigs": len(lens), "total_bases": total, "n50": n50,
            "genome_kmer_fraction": round(float(covered)
                                          / max(len(g_keys), 1), 4)}


def _accuracy(in_reads, out_paths) -> dict:
    """Error-correction gain: (errors fixed - errors introduced) / errors."""
    from kmerax.io.fastq import read_fastq
    from oracle.codec import seq_to_bases

    before = after = introduced = total = 0
    for reads, path in zip(in_reads, out_paths):
        recs = read_fastq(path)
        assert len(recs) == len(reads), (len(recs), len(reads))
        for r, rec in zip(reads, recs):
            fixed = seq_to_bases(rec.seq.decode("ascii"))
            err0 = r.bases != r.true_bases
            err1 = fixed != r.true_bases
            before += int(err0.sum())
            after += int((err0 & err1).sum())
            introduced += int((~err0 & err1).sum())
            total += len(r.bases)
    gain = (before - after - introduced) / max(before, 1)
    return {"errors_before": before, "errors_remaining": after,
            "errors_introduced": introduced, "bases": total,
            "gain": round(gain, 4)}


def run_config(n: int, scale="1.0", workdir: str | None = None,
               seed: int = 42, overrides: dict | None = None) -> dict:
    """Run acceptance config `n` end-to-end; returns the metrics dict.

    scale: genome-length multiplier of the spec's scale-down base, or the
    string "full" for the real dataset size (e.g. config 1 = the 4.6Mb
    E. coli genome, ~1.5M PE150 reads at 50x).
    overrides: KmeraxConfig field overrides (e.g. a deliberately small
    exact_capacity to exercise the host-resident spectrum, or a wider mesh).
    """
    import tempfile

    import jax

    from kmerax.pipeline import run_pipeline
    from kmerax.pipeline.twopass import run_two_pass

    spec = CONFIGS[n]
    if scale == "full":
        scale = spec.full_genome_len / spec.genome_len
    scale = float(scale)
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix=f"kmerax_acc{n}_")
    os.makedirs(workdir, exist_ok=True)

    ov = overrides or {}
    mesh_d = ov.get("mesh_data", spec.mesh[0])
    mesh_b = ov.get("mesh_bucket", spec.mesh[1])
    n_dev = len(jax.devices())
    if mesh_d * mesh_b > n_dev:
        raise ValueError(
            f"config {n} asks for a {mesh_d}x{mesh_b} mesh but JAX has "
            f"{n_dev} device(s); pass a smaller mesh through overrides")

    genome, paths, sim_reads = _sim_inputs(spec, scale, workdir, seed)
    n_reads = sum(len(r) for r in sim_reads)

    # distinct k-mers ~ genome + error-induced novels (each error spawns up
    # to ~k unseen k-mers, clustered); 1.75x margin, pow2
    distinct = (len(genome)
                + n_reads * spec.read_len * spec.error_rate * spec.k)
    cap = 1 << max(13, int(np.ceil(np.log2(distinct * 1.75))))
    # Bloom load <= ~0.5 probes/counter so solidity stays discriminative
    width = max(18, min(30, int(np.ceil(np.log2(distinct * 6)))))
    batch_reads = 4096 if n_reads >= 64 * 1024 else 1024
    cfg = KmeraxConfig(
        k=spec.k, k2=spec.k2, mesh_data=mesh_d, mesh_bucket=mesh_b,
        exact_capacity=cap, batch_reads=batch_reads,
        max_read_len=spec.read_len + 10, bloom_log2_width=width)
    if overrides:
        cfg = cfg.replace(**overrides)
    out_fastq = [os.path.join(workdir, f"corrected_{i+1}.fastq")
                 for i in range(len(paths))]
    out_fasta = os.path.join(workdir, "contigs.fasta") if spec.assemble \
        else None
    metrics = os.path.join(workdir, "metrics.jsonl")

    t0 = time.perf_counter()
    if spec.k2:
        result = run_two_pass(cfg, paths, out_fastq[0] if len(paths) == 1
                              else out_fastq, out_fasta,
                              metrics_path=metrics,
                              workdir=os.path.join(workdir, "ckpt"))
        out_list = out_fastq if len(paths) > 1 else [out_fastq[0]]
    else:
        # per-file outputs (paired-end R1/R2) via run_correct's group mode
        from kmerax.pipeline import run_count, run_correct
        from kmerax.utils.metrics import MetricsWriter
        m = MetricsWriter(metrics)
        state = run_count(cfg, paths, metrics=m)
        stats = run_correct(cfg, paths, state,
                            out_fastq if len(paths) > 1 else out_fastq[0],
                            metrics=m)
        result = {"threshold": state.threshold, **stats}
        if out_fasta is not None:
            from kmerax.graph import assemble_to_fasta
            n_unitigs = assemble_to_fasta(
                cfg, state, out_fasta,
                corrected_fastq=out_fastq if len(out_fastq) > 1
                else out_fastq[0])
            result["unitigs"] = n_unitigs
            # seed-extend validation stage (DESIGN.md §10b): corrected
            # reads aligned back to the contigs
            from kmerax.pipeline import run_align
            result["validate"] = run_align(cfg, out_fastq, out_fasta,
                                           metrics=m)
        m.close()
        out_list = out_fastq
    wall = time.perf_counter() - t0

    acc = _accuracy(sim_reads, out_list)
    asm = None
    if out_fasta is not None and os.path.exists(out_fasta):
        asm = assembly_metrics(genome, out_fasta, spec.k2 or spec.k)
    report = {
        "config": n, "name": spec.name, "note": spec.note,
        "scale": scale, "genome_len": len(genome), "reads": n_reads,
        "mesh": [mesh_d, mesh_b], "backend": jax.default_backend(),
        "wall_s": round(wall, 3),
        "reads_per_s": round(n_reads / wall, 1),
        **{k: v for k, v in result.items() if k != "reads"},
        "accuracy": acc, "workdir": workdir,
    }
    if asm is not None:
        report["assembly"] = asm
    return report


def run_all(scale: float = 1.0, configs=None) -> list:
    return [run_config(n, scale) for n in (configs or sorted(CONFIGS))]
