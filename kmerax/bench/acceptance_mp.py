"""Multi-PROCESS acceptance runs (BASELINE.md config 4: "sharded k-mer
spectrum across 2 hosts, merged counts"): true jax.distributed processes
(one per emulated host, 4 fake CPU devices each) running the production
CLI pipeline — per-host input parsing, all-to-all bucket routing, the
range-sharded host spectrum (multi-host default), per-host correction.
The parent process simulates the inputs once, spawns the workers, then
scores accuracy (and assembly quality when the config assembles) exactly
like the single-process acceptance harness.

CPU emulation only: the workers force the CPU backend
(`_accept_worker.py`), since every JAX process would reserve most of a
GPU's memory. Four GPUs of one host run configs 4-5 from one process
(`run_config` with a mesh override).

Usage:  python -m kmerax.bench.acceptance_mp --config 4 --scale 166.7 \
            --out ACCEPTANCE_full_c4.json
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_config_mp(n: int, scale="1.0", n_procs: int = 2,
                  workdir: str | None = None, seed: int = 42,
                  scale_note: str = "") -> dict:
    import tempfile

    from kmerax.bench.acceptance import (
        CONFIGS, _accuracy, _sim_inputs, assembly_metrics,
    )

    spec = CONFIGS[n]
    if scale == "full":
        scale = spec.full_genome_len / spec.genome_len
    scale = float(scale)
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix=f"kmerax_acc{n}_mp_")
    os.makedirs(workdir, exist_ok=True)

    genome, paths, sim_reads = _sim_inputs(spec, scale, workdir, seed)
    n_reads = sum(len(r) for r in sim_reads)

    distinct = (len(genome)
                + n_reads * spec.read_len * spec.error_rate * spec.k)
    cap = 1 << max(13, int(np.ceil(np.log2(distinct * 1.75))))
    width = max(18, min(30, int(np.ceil(np.log2(distinct * 6)))))
    batch_reads = 4096 if n_reads >= 64 * 1024 else 1024

    out_fastq = [os.path.join(workdir, f"corrected_{i+1}.fastq")
                 for i in range(len(paths))]
    out_fasta = os.path.join(workdir, "contigs.fasta") if spec.assemble \
        else None

    coord = f"localhost:{_free_port()}"
    mesh_d, mesh_b = n_procs, 4          # 4 fake devices per process
    args = ["pipeline", "-k", str(spec.k),
            "--bloom-log2-width", str(width),
            "--batch-reads", str(batch_reads),
            "--max-read-len", str(spec.read_len + 10),
            "--exact-capacity", str(cap),
            "--mesh-data", str(mesh_d), "--mesh-bucket", str(mesh_b),
            "--coordinator", coord, "--num-procs", str(n_procs),
            "--in", *paths,
            "--out-fastq", *out_fastq]
    if spec.k2:
        args += ["--k2", str(spec.k2)]
    if out_fasta:
        args += ["--out-fasta", out_fasta]

    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "_accept_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    t0 = time.perf_counter()
    # stdout goes to per-worker log files: a PIPE left undrained while
    # waiting on another worker can fill its 64KB OS buffer and deadlock
    # the whole lockstep run
    logs = [os.path.join(workdir, f"worker{pid}.log")
            for pid in range(n_procs)]
    procs = [subprocess.Popen(
        [sys.executable, worker, *args, "--process-id", str(pid)],
        env=env, stdout=open(logs[pid], "wb"), stderr=subprocess.STDOUT)
        for pid in range(n_procs)]
    for p in procs:
        p.wait()
    wall = time.perf_counter() - t0
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[pid], "rb") as fh:
                out = fh.read().decode(errors="replace")
            raise RuntimeError(
                f"acceptance worker {pid} failed:\n{out[-6000:]}")

    acc = _accuracy(sim_reads, out_fastq)
    report = {
        "config": n, "name": spec.name, "note": spec.note,
        "scale": scale, "genome_len": len(genome), "reads": n_reads,
        "n_procs": n_procs, "mesh": [mesh_d, mesh_b], "backend": "cpu",
        "memory_model": "range-sharded host spectrum (multi-host default)",
        "wall_s": round(wall, 3),
        "reads_per_s": round(n_reads / wall, 1),
        "accuracy": acc, "workdir": workdir,
    }
    if out_fasta is not None and os.path.exists(out_fasta):
        report["assembly"] = assembly_metrics(
            genome, out_fasta, spec.k2 or spec.k)
    if scale_note:
        report["scale_note"] = scale_note
    return report


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, required=True)
    ap.add_argument("--scale", default="1.0")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--scale-note", default="")
    args = ap.parse_args()
    report = run_config_mp(args.config, args.scale, args.procs,
                           args.workdir, scale_note=args.scale_note)
    line = json.dumps(report, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
