"""Device mesh & multi-host runtime (SURVEY.md §2 #20; DESIGN.md §12).

The reference is single-node pthreads; the rebuild's communication backend is
XLA collectives (NCCL over NVLink within a host, the network across
hosts), set up with one process per host via jax.distributed. Mesh axes:

  "data"   — reads are sharded over it (DP); partial spectra merged across it
  "bucket" — the spectrum (Bloom/exact shards) is sharded over it (TP/EP);
             k-mers are all-to-all routed to their minimizer-bucket owner

Device order: jax.make_mesh lays hosts out contiguously, so the "data" axis
crosses hosts only when it must and "bucket" routing stays within a host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kmerax.utils.logging import get_logger

log = get_logger("kmerax.dist")

AXIS_DATA = "data"
AXIS_BUCKET = "bucket"


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    bucket: int = 1

    @property
    def ndev(self) -> int:
        return self.data * self.bucket


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """jax.distributed.initialize for multi-host runs (SURVEY.md §3.4).

    No-ops for single-process. Args default from env
    (KMERAX_COORDINATOR/KMERAX_NUM_PROCS/KMERAX_PROCESS_INDEX).
    """
    coordinator = coordinator or os.environ.get("KMERAX_COORDINATOR")
    if coordinator is None:
        return
    num_processes = num_processes or int(os.environ["KMERAX_NUM_PROCS"])
    process_id = process_id if process_id is not None \
        else int(os.environ["KMERAX_PROCESS_INDEX"])
    jax.distributed.initialize(coordinator, num_processes, process_id)
    log.info("distributed init: process %d/%d, %d local / %d global devices",
             process_id, num_processes,
             jax.local_device_count(), jax.device_count())


def make_mesh(spec: MeshSpec, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if spec.ndev > len(devices):
        raise ValueError(
            f"mesh {spec.data}x{spec.bucket} needs {spec.ndev} devices, "
            f"have {len(devices)}")
    devs = np.asarray(devices[:spec.ndev]).reshape(spec.data, spec.bucket)
    return Mesh(devs, (AXIS_DATA, AXIS_BUCKET))


def local_batch_slice(mesh: Mesh, global_batch: int) -> slice:
    """This process's row range of a [global_batch, ...] read array sharded
    over ("data","bucket") — for multi-host feeding (each host reads its own
    shard of the input files)."""
    idx = jax.process_index()
    n = jax.process_count()
    assert global_batch % n == 0
    per = global_batch // n
    return slice(idx * per, (idx + 1) * per)


def reads_sharding(mesh: Mesh) -> NamedSharding:
    """Reads sharded over both axes (Ulysses-shaped reshard, SURVEY.md §2)."""
    return NamedSharding(mesh, P((AXIS_DATA, AXIS_BUCKET)))


def table_sharding(mesh: Mesh) -> NamedSharding:
    """Per-(data,bucket) partial Bloom shards: (D, S, width)."""
    return NamedSharding(mesh, P(AXIS_DATA, AXIS_BUCKET))
