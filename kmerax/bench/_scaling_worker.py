"""Worker for the multi-host scaling bench (kmerax/bench/scaling.py).

One process = one emulated host with D fake CPU devices. Each host
simulates and streams ITS OWN read shard (multi-host streamed input,
BASELINE.json:5), the spectrum is bucket-sharded over the global mesh, and
host 0 reports timed steady-state count throughput as one JSON line.

argv: coordinator nprocs pid devices_per_host n_batches batch_reads_per_host
"""

import json
import os
import sys
import time


def main():
    (coordinator, nprocs, pid, dph, n_batches, batch_per_host) = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
        int(sys.argv[5]), int(sys.argv[6]))
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dph}")
    os.environ["KMERAX_PROCESS_INDEX"] = str(pid)
    import jax

    jax.config.update("jax_platforms", "cpu")
    if nprocs > 1:
        jax.distributed.initialize(coordinator, nprocs, pid)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    from kmerax.config import KmeraxConfig
    from kmerax.dist.mesh import MeshSpec, make_mesh, local_batch_slice
    from kmerax.pipeline.run import _bloom_params
    from kmerax.spectrum.sharded import (
        ShardedParams, make_sharded_state, sharded_insert_step,
    )

    n_dev = nprocs * dph
    read_len = 150
    k = 31
    # mesh: data axis = hosts (DP over read shards), bucket axis = chips
    # within a host (TP over spectrum segments) — cross-host traffic rides
    # "data", within-host traffic rides "bucket", matching the production
    # layout.
    mesh = make_mesh(MeshSpec(nprocs, dph))
    cfg = KmeraxConfig(k=k, bloom_log2_width=20,
                       mesh_data=nprocs, mesh_bucket=dph)
    sp = ShardedParams(_bloom_params(cfg, k), n_shards=dph)
    table, _ = make_sharded_state(sp, mesh, None, k)
    step = sharded_insert_step(sp, mesh, k, None)

    # per-host deterministic read shard (weak scaling: work/host constant)
    rng = np.random.default_rng(1000 + pid)
    genome = rng.integers(0, 4, 1 << 17).astype(np.uint8)
    B_global = batch_per_host * nprocs
    sharding = NamedSharding(mesh, P(("data", "bucket")))

    def make_batch(seed):
        r = np.random.default_rng(seed * 7919 + pid)
        starts = r.integers(0, len(genome) - read_len, batch_per_host)
        reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
        return reads.astype(np.int32)

    sl = local_batch_slice(mesh, B_global)
    batches = [jax.make_array_from_process_local_data(
        sharding, make_batch(s), global_shape=(B_global, read_len))
        for s in range(3)]

    # warmup (compile)
    table, _, nk, _ = step(table, None, batches[0])
    int(nk)
    t0 = time.perf_counter()
    total = 0
    for i in range(n_batches):
        table, _, nk, _ = step(table, None, batches[i % 3])
        total += int(nk)      # readback = host-side sync each step
    dt = time.perf_counter() - t0

    reads_s = B_global * n_batches / dt
    kmers_s = total / dt

    # correction weak-scaling (BASELINE >=0.8 applies to reads/s, i.e. the
    # correct stage must scale too): mesh-sharded correct_batch against the
    # merged replicated solidity bitmap — the production
    # pipeline._correct_step_mesh layout.
    from jax import shard_map
    from jax.sharding import PartitionSpec
    from kmerax.ops.correct import correct_batch
    from kmerax.spectrum.bloom import query_solid, solidity_bitmap
    from kmerax.spectrum.sharded import merge_and_replicate

    merged = merge_and_replicate(mesh)(table)
    bitmap = jax.jit(solidity_bitmap, static_argnums=0)(sp.bloom, merged, 3)
    rspec = PartitionSpec(("data", "bucket"))
    lengths = jax.make_array_from_process_local_data(
        NamedSharding(mesh, rspec),
        np.full(batch_per_host, read_len, np.int32),
        global_shape=(B_global,))

    def local(bm, b, l):
        sf = lambda cw, v: query_solid(sp.bloom, bm, cw, v)
        return correct_batch(b, l, k, 3, solid_fn=sf,
                             rounds=2, max_runs=8, max_edits=8)

    sm = shard_map(local, mesh=mesh,
                   in_specs=(PartitionSpec(None), rspec, rspec),
                   out_specs=(rspec, rspec), check_vma=False)
    cstep = jax.jit(lambda b, l: sm(bitmap, b, l))
    tot = jax.jit(lambda x: jnp.sum(x))

    nb_c = max(2, n_batches // 2)
    _, ne = cstep(batches[0], lengths)
    int(tot(ne))                         # compile + sync
    t0 = time.perf_counter()
    for i in range(nb_c):
        _, ne = cstep(batches[i % 3], lengths)
        int(tot(ne))
    dt_c = time.perf_counter() - t0
    correct_reads_s = B_global * nb_c / dt_c

    if pid == 0:
        print("SCALING_RESULT " + json.dumps({
            "hosts": nprocs, "devices": n_dev,
            "reads_per_s": round(reads_s, 1),
            "kmers_per_s": round(kmers_s, 1),
            "correct_reads_per_s": round(correct_reads_s, 1),
            "wall_s": round(dt, 4)}), flush=True)
    if nprocs > 1:
        jax.distributed.shutdown()
    print(f"worker {pid} OK", flush=True)


if __name__ == "__main__":
    main()
