"""What ``BENCHMARK.json`` names, found by name as files of their own.

- a configuration: ``benchmark/configs/<config>.json``: the database's
  subjects, the CLI's words (``cli``), the check's scores and, where the
  deployment needs them, the program's environment settings (``env``,
  such as ``GBLASTN_TPU_STREAM`` or ``GBLASTN_TPU_SHARDS``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, parameters read by
  the one generator in ``harness/data.py``; its ``loop`` names the
  window's loop, ``benchmark/loops/<loop>.py``, whose ``window(session)``
  drives a ``harness.loop.Session``;
- the limits of a cell's correctness check: ``benchmark/limits/<cell>.json``;
- a metric, end-to-end or per-layer: ``benchmark/metrics/<metric>.py``,
  whose ``read(run)`` returns the metric's value from a
  ``harness.loop.Run``, or None where the run has nothing to read it from.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(BENCH_DIR / "limits" / f"{cell_name}.json")


def _module(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module("metrics", name).read


def loop(name: str):
    """The ``window`` function of ``loops/<name>.py``."""
    return _module("loops", name).window


def metrics_of(cell_name: str, bench: dict | None = None):
    """The cell's end-to-end and per-layer metric entries."""
    bench = bench or benchmark()

    def mine(m):
        return cell_name in m.get("workloads", [cell_name])

    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])
