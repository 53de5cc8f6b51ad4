#!/usr/bin/env python
"""Benchmark entry: prints the device, then ONE JSON line with the metrics.

Headline = k-mers/s/chip at k=31 (BASELINE.json:2 counting north-star),
plus the correction, align and end-to-end rates as extra keys, all with
the chained fresh-batch methodology of kmerax/bench/runners.py. Runs only
on an NVIDIA GPU: on any other device it exits non-zero with no result.
"""

import json
import sys

sys.path.insert(0, __file__.rsplit("/", 1)[0])


def main():
    from kmerax.bench.device import card_name_power, require_gpu

    device = require_gpu()
    print(f"device: {device['platform']} {device['kind']} "
          f"x{device['count']}; card: {card_name_power()}", flush=True)
    from kmerax.utils.compile_cache import enable
    enable()
    from kmerax.config import KmeraxConfig
    from kmerax.bench.runners import (
        bench_align, bench_correct, bench_count, bench_e2e,
    )

    cfg = KmeraxConfig(k=31, bloom_log2_width=24)
    r = bench_count(cfg, n_reads=16384)
    c = bench_correct(cfg, n_reads=4096)
    a = bench_align(cfg, n_reads=16384)
    e = bench_e2e(cfg, n_reads=65536)
    print(json.dumps({"metric": r["metric"], "value": r["value"],
                      "unit": r["unit"],
                      "correct_metric": c["metric"],
                      "correct_value": c["value"],
                      "correct_unit": c["unit"],
                      "align_metric": a["metric"],
                      "align_value": a["value"],
                      "align_unit": a["unit"],
                      "e2e_metric": e["metric"],
                      "e2e_value": e["value"],
                      "e2e_unit": e["unit"],
                      "device": device}))


if __name__ == "__main__":
    main()
