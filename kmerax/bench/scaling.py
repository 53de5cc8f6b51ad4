"""Multi-host scaling-efficiency bench (BASELINE.md: >=0.8 linear 1->4 hosts).

Weak-scaling methodology: per-host work is held constant (each host streams
its own read shard) while host count grows 1 -> 2 -> 4; efficiency =
reads/s(N hosts) / (N * reads/s(1 host)). Hosts are emulated as one
process each with `devices_per_host` fake CPU devices and real
jax.distributed + collective traffic over loopback. This is CPU emulation
only: the workers force the CPU backend (`_scaling_worker.py`), so no
number from it is a device number — it validates the measurement path and
catches scaling regressions in the collective layout. Four GPUs of one
host are driven by one process over a device mesh instead.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_point(nprocs: int, devices_per_host: int, n_batches: int,
               batch_per_host: int, timeout: int = 600) -> dict:
    worker = os.path.join(os.path.dirname(__file__), "_scaling_worker.py")
    coord = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, str(nprocs), str(pid),
         str(devices_per_host), str(n_batches), str(batch_per_host)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nprocs)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"scaling worker {pid} failed:\n{out[-3000:]}")
    for out in outs:
        for line in out.splitlines():
            if line.startswith("SCALING_RESULT "):
                return json.loads(line[len("SCALING_RESULT "):])
    raise RuntimeError("no SCALING_RESULT line:\n" + outs[0][-2000:])


def run_scaling(host_counts=(1, 2, 4), devices_per_host: int = 2,
                n_batches: int = 8, batch_per_host: int = 2048) -> dict:
    """Measure weak-scaling efficiency across emulated host counts."""
    points = []
    for n in host_counts:
        r = _run_point(n, devices_per_host, n_batches, batch_per_host)
        points.append(r)
    base = points[0]["reads_per_s"] / points[0]["hosts"]
    cbase = points[0]["correct_reads_per_s"] / points[0]["hosts"]
    for r in points:
        r["efficiency"] = round(r["reads_per_s"] / (r["hosts"] * base), 4)
        r["correct_efficiency"] = round(
            r["correct_reads_per_s"] / (r["hosts"] * cbase), 4)
    return {"metric": "weak_scaling_efficiency",
            "backend": "cpu-emulated (loopback network)",
            "per_host_devices": devices_per_host,
            "points": points,
            "efficiency_1_to_max": points[-1]["efficiency"],
            "target": 0.8,
            "note": "CPU-emulated hosts; the numbers validate the "
                    "measurement path only"}
