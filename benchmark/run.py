#!/usr/bin/env python3
"""Run one cell of the benchmark of gblastn_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The cell, its configuration, its traffic mix and the mix's
loop, its limits and its metrics are found by name
(``harness/spec.py``). The last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared, with its limit.
The same numbers end standard error. Without the cards, or where a
forbidden module was loaded, it prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started (from /proc; 0 where absent)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age()
# one thread in each of torch's, OpenMP's and BLAS's pools: the program's
# host stages run in one Python thread, and more threads only load the
# shared host (PERF.md, section 6)
os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                  OPENBLAS_NUM_THREADS="1")
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

# the program's spans printed a batch at a time on standard error
SPANS_SHOWN = ("setup.lookup_table", "setup.dust", "device.seeding",
               "host.prelim_gapped", "host.traceback")


def result_line(run, summary, cell, e2e, per_layer, trace, kind) -> dict:
    """The result's JSON object: the cell's end-to-end metrics (trace 0)
    or the per-layer metrics that found something to read (trace 1), the
    device, a traced run's breakdown, and last the numbers compared with
    their limits."""
    from harness import spec

    metrics = {}
    for m in (per_layer if trace else e2e):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": int(cell["chips"]),
              "memory_peak_bytes": run.peak_bytes}
    result = {"correct": summary["correct"], "attempted": run.reads,
              "failed": 0, "metrics": metrics, "device": device}
    if trace and run.trace:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["check"] = summary["numbers"]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import guard, spec

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limit = spec.limits(cell["name"])["wrong_reads_pct"]
    e2e, per_layer = spec.metrics_of(cell["name"], bench)

    import torch

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"benchmark: {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 2

    # the program's settings that the configuration states (streaming,
    # shards), before the program is imported
    os.environ.update({k: str(v) for k, v in config.get("env", {}).items()})
    from harness import loop

    loop.cache_dirs(ROOT)
    run, summary = loop.run_cell(config, traffic, limit, args.seed,
                                 args.seconds, args.trace, "cuda", T0)

    bad = guard.forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3

    result = result_line(run, summary, cell, e2e, per_layer, args.trace,
                         torch.cuda.get_device_name(0))
    use = resource.getrusage(resource.RUSAGE_SELF)
    rss = use.ru_maxrss / 2**20
    print(f"benchmark: {cell['name']} seed {args.seed}: {run.batches} "
          f"batches, {run.reads} reads in {run.window_s:.3f} s; set-up "
          f"{run.setup_s:.3f} s (cold batch {run.cold_batch_s:.3f} s); "
          f"traced {run.traced_batches} of them; "
          f"compared {summary['compared']} reads, {summary['wrong']} wrong "
          f"{summary['kinds']}; peak RSS {rss:.2f} GiB", file=sys.stderr)
    print(f"benchmark: process CPU {use.ru_utime + use.ru_stime:.1f} s in "
          f"{time.perf_counter() - T0:.1f} s", file=sys.stderr)
    print("benchmark: batch seconds " + " ".join(
        f"{x:.3f}" for x in run.batch_s), file=sys.stderr)
    for name in SPANS_SHOWN:
        print(f"benchmark: batch {name} " + " ".join(
            f"{s.get(name, 0.0):.3f}" for s in run.batch_spans),
            file=sys.stderr)
    for name, n in summary["numbers"].items():
        print(f"check: {name} {n['value']} limit {n['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
