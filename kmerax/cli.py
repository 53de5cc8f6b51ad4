"""kmerax command line (SURVEY.md §2 #18; L6 of the layer map).

Subcommands: count | correct | assemble | pipeline | bench.
Config precedence: defaults < --config TOML < explicit flags.
"""

from __future__ import annotations

import argparse
import json
import sys

from kmerax.config import KmeraxConfig
from kmerax.utils.logging import get_logger

log = get_logger("kmerax.cli")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", help="TOML config file")
    p.add_argument("-k", type=int, default=None, help="k-mer size (odd, <=63)")
    p.add_argument("--threshold", type=int, default=None,
                   help="solid threshold (default: auto from histogram)")
    p.add_argument("--batch-reads", type=int, default=None)
    p.add_argument("--max-read-len", type=int, default=None)
    p.add_argument("--bloom-log2-width", type=int, default=None)
    p.add_argument("--exact-capacity", type=int, default=None)
    p.add_argument("--no-exact", action="store_true",
                   help="skip the exact spectrum (needs --threshold)")
    p.add_argument("--shard-host-spectrum", action="store_true",
                   help="force the key-range-sharded exact spectrum "
                        "(~1/P resident rows per host; k <= 63) — already "
                        "the DEFAULT on multi-host runs")
    p.add_argument("--no-shard-host-spectrum", action="store_true",
                   help="force full spectrum replication onto every host "
                        "(small-run fast path)")
    p.add_argument("--no-wire-pack", action="store_true",
                   help="disable the 2-bit host<->device wire (io/wire.py)"
                        " — every batch uses the int8 wire")
    p.add_argument("--metrics", default=None, help="metrics.jsonl path")
    # mesh / multi-host (SURVEY.md §3.4): mesh axes, then one process per
    # host with --coordinator host:port --num-procs N --process-id P
    # (or KMERAX_COORDINATOR / KMERAX_NUM_PROCS / KMERAX_PROCESS_INDEX)
    p.add_argument("--mesh-data", type=int, default=None,
                   help='mesh "data" axis size (DP over reads)')
    p.add_argument("--mesh-bucket", type=int, default=None,
                   help='mesh "bucket" axis size (spectrum sharding)')
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for jax.distributed")
    p.add_argument("--num-procs", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _cfg(args) -> KmeraxConfig:
    return KmeraxConfig.load(
        args.config,
        k=args.k, threshold=args.threshold, batch_reads=args.batch_reads,
        max_read_len=args.max_read_len,
        bloom_log2_width=args.bloom_log2_width,
        exact_capacity=args.exact_capacity,
        exact_spectrum=False if args.no_exact else None,
        shard_host_spectrum=(True if args.shard_host_spectrum else
                             False if args.no_shard_host_spectrum else
                             None),
        wire_pack=False if args.no_wire_pack else None,
        mesh_data=args.mesh_data, mesh_bucket=args.mesh_bucket,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="kmerax",
        description="Short-read k-mer counting, correction & assembly")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("count", help="k-mer count pass; saves a spectrum dir")
    _add_common(p)
    p.add_argument("--in", dest="inputs", nargs="+", required=True)
    p.add_argument("--out", required=True, help="spectrum output directory")

    p = sub.add_parser("correct", help="error-correct reads")
    _add_common(p)
    p.add_argument("--in", dest="inputs", nargs="+", required=True)
    p.add_argument("--out", required=True, nargs="+",
                   help="corrected FASTQ path(s); give one per input for "
                        "paired-end R1/R2 outputs")
    p.add_argument("--spectrum", help="spectrum dir from `count` (else counts first)")
    p.add_argument("--use-exact", action="store_true",
                   help="query the exact spectrum instead of the Bloom")

    p = sub.add_parser("assemble", help="unitig assembly to FASTA")
    _add_common(p)
    p.add_argument("--in", dest="inputs", nargs="+",
                   help="reads to (re)count for the graph")
    p.add_argument("--spectrum", help="spectrum dir from `count`")
    p.add_argument("--out", required=True, help="contig FASTA path")

    p = sub.add_parser("align", help="seed-extend align/validate reads "
                                     "against contigs (DESIGN.md 10b)")
    _add_common(p)
    p.add_argument("--in", dest="inputs", nargs="+", required=True)
    p.add_argument("--contigs", required=True, help="contig FASTA")
    p.add_argument("--out", default=None, help="per-read TSV "
                   "(name, found, strand, pos, score, identity)")

    p = sub.add_parser("pipeline", help="count+correct(+assemble) end to end")
    _add_common(p)
    p.add_argument("--in", dest="inputs", nargs="+", required=True)
    p.add_argument("--out-fastq", required=True, nargs="+",
                   help="one path, or one per input file (paired-end R1/R2)")
    p.add_argument("--out-fasta", default=None)
    p.add_argument("--validate", action="store_true",
                   help="after assemble: seed-extend align corrected reads "
                        "back to the contigs and report identity")
    p.add_argument("--k2", type=int, default=None,
                   help="second-pass k for correct+assemble (BASELINE config 5)")

    p = sub.add_parser("bench", help="run the benchmark harness")
    _add_common(p)
    p.add_argument("--preset", default="count",
                   choices=["count", "correct", "align", "e2e", "all"])
    p.add_argument("--reads", type=int, default=20000)
    p.add_argument("--acceptance", type=int, default=None, metavar="N",
                   help="run BASELINE.md acceptance config N (1-5) "
                        "end-to-end on simulated data")
    p.add_argument("--scale", default="1.0",
                   help="genome scale factor for --acceptance, or 'full' "
                        "for the real dataset size (config 1 = 4.6Mb)")
    p.add_argument("--scaling", action="store_true",
                   help="multi-host weak-scaling efficiency (emulated "
                        "hosts on CPU; run on a real slice for BASELINE "
                        "numbers)")
    p.add_argument("--hosts", type=int, nargs="+", default=[1, 2, 4],
                   help="host counts for --scaling")

    args = ap.parse_args(argv)

    import os
    if getattr(args, "coordinator", None) or os.environ.get(
            "KMERAX_COORDINATOR"):
        from kmerax.dist.mesh import init_distributed
        init_distributed(args.coordinator, args.num_procs, args.process_id)

    from kmerax.utils.compile_cache import enable as _enable_cache
    _enable_cache()
    cfg = _cfg(args)

    if args.cmd == "count":
        from kmerax.pipeline import run_count, save_spectrum
        from kmerax.utils.metrics import MetricsWriter
        state = run_count(cfg, args.inputs,
                          metrics=MetricsWriter(args.metrics))
        save_spectrum(args.out, cfg, bloom_table=state.bloom_table,
                      exact=state.exact, threshold=state.threshold,
                      hist=state.hist, host=state.host,
                      extra={"n_reads": state.n_reads,
                             "n_kmers": state.n_kmers})
        print(json.dumps({"reads": state.n_reads, "kmers": state.n_kmers,
                          "threshold": state.threshold}))

    elif args.cmd == "correct":
        from kmerax.pipeline import run_correct, run_count
        from kmerax.pipeline.run import CountState
        from kmerax.utils.metrics import MetricsWriter
        m = MetricsWriter(args.metrics)
        state = _load_or_count(cfg, args, m)
        out = args.out if len(args.out) > 1 else args.out[0]
        stats = run_correct(cfg, args.inputs, state, out, metrics=m,
                            use_exact=args.use_exact)
        print(json.dumps({"threshold": state.threshold, **stats}))

    elif args.cmd == "assemble":
        from kmerax.graph import assemble_to_fasta
        from kmerax.utils.metrics import MetricsWriter
        m = MetricsWriter(args.metrics)
        state = _load_or_count(cfg, args, m)
        n = assemble_to_fasta(cfg, state, args.out)
        print(json.dumps({"unitigs": n, "threshold": state.threshold}))

    elif args.cmd == "align":
        from kmerax.pipeline.run import run_align
        from kmerax.utils.metrics import MetricsWriter
        stats = run_align(cfg, args.inputs, args.contigs, out_tsv=args.out,
                          metrics=MetricsWriter(args.metrics))
        print(json.dumps(stats))

    elif args.cmd == "pipeline":
        from kmerax.pipeline import run_pipeline
        out_fq = args.out_fastq[0] if len(args.out_fastq) == 1 \
            else list(args.out_fastq)
        if args.k2:
            from kmerax.pipeline.twopass import run_two_pass
            result = run_two_pass(cfg.replace(k2=args.k2), args.inputs,
                                  out_fq, args.out_fasta,
                                  metrics_path=args.metrics)
        else:
            result = run_pipeline(cfg, args.inputs, out_fq,
                                  args.out_fasta, metrics_path=args.metrics,
                                  validate=args.validate)
        print(json.dumps(result))

    elif args.cmd == "bench":
        if args.scaling:
            from kmerax.bench.scaling import run_scaling
            print(json.dumps(run_scaling(host_counts=tuple(args.hosts))))
        elif args.acceptance is not None:
            from kmerax.bench.acceptance import run_config
            print(json.dumps(run_config(args.acceptance, scale=args.scale)))
        else:
            from kmerax.bench.runners import run_preset
            print(json.dumps(run_preset(args.preset, cfg, n_reads=args.reads)))

    return 0


def _load_or_count(cfg, args, m):
    from kmerax.pipeline import load_spectrum, run_count
    from kmerax.pipeline.run import CountState
    import jax.numpy as jnp
    import numpy as np
    if getattr(args, "spectrum", None):
        manifest, arrays = load_spectrum(args.spectrum)
        if manifest is None:
            log.error("no spectrum at %s", args.spectrum)
            sys.exit(2)
        scfg = KmeraxConfig(**manifest["config"])
        exact = None
        if "exact_uniq" in arrays:
            exact = (jnp.asarray(arrays["exact_uniq"]),
                     jnp.asarray(arrays["exact_counts"]),
                     jnp.asarray(arrays["exact_n"]))
        return CountState(
            scfg, jnp.asarray(arrays["bloom_table"]), exact,
            arrays.get("hist"), manifest["threshold"],
            manifest.get("n_reads", 0), manifest.get("n_kmers", 0))
    if not getattr(args, "inputs", None):
        log.error("need --in reads or --spectrum dir")
        sys.exit(2)
    return run_count(cfg, args.inputs, metrics=m)


if __name__ == "__main__":
    sys.exit(main())
