"""BENCHMARK.json against the contract's shape, and everything it names
found by name; the result line's shape."""
import json
import re

from harness import spec
from harness.loop import Run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_benchmark_json_keeps_the_contracts_shape():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    for part, keys in KEYS.items():
        names = [e["name"] for e in b[part]]
        assert len(names) == len(set(names))
        for e in b[part]:
            assert set(e) - {"workloads"} == keys, e["name"]
            assert NAME.match(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"]:
        assert m["source"] in ("device_trace", "host_clock")
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_is_found_as_a_file():
    b = spec.benchmark()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"]
        assert configs[w["config"]]["file"] == \
            f"benchmark/configs/{w['config']}.json"
        assert spec.traffic(w["traffic"])["pool_batches"] >= 2
        assert spec.limits(w["name"])["wrong_reads_pct"] >= 0
        assert spec.cell(w["name"], b) is w
        e2e, per_layer = spec.metrics_of(w["name"], b)
        assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
        assert per_layer
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_readers_return_nothing_where_nothing_was_read():
    empty = Run()
    b = spec.benchmark()
    for m in b["end_to_end"] + b["per_layer"]:
        assert spec.metric_reader(m["name"])(empty) is None


def test_every_mix_names_a_loop_found_by_name():
    for w in spec.benchmark()["workloads"]:
        assert callable(spec.loop(spec.traffic(w["traffic"])["loop"]))


def _run():
    r = Run(batches=3, reads=150, window_s=12.5, setup_s=30.0,
            cold_batch_s=9.0, format_s=0.3, seeding_bytes=3e9,
            peak_bytes=5 << 30, span_batches=2, traced_batches=1)
    r.spans = {"setup.query_block": 0.1, "setup.dust": 0.2,
               "setup.lookup_table": 0.3, "device.seeding": 0.9,
               "host.prelim_gapped": 1.2, "host.traceback": 2.4}
    r.trace = {"window_s": 12.4, "busy_s": 3.1, "seeding_kernel_s": 0.8,
               "scan_kernel_s": 0.6, "device_ops": [["k1_kernel", 0.1]],
               "idle_gaps": [["host.traceback", 2.0]]}
    return r


def test_result_line_shape():
    import run as runner

    b = spec.benchmark()
    cell = spec.cell("hg-mb.map", b)
    e2e, per_layer = spec.metrics_of(cell["name"], b)
    summary = {"correct": True,
               "numbers": {"wrong_reads_pct": {"value": 0.0, "limit": 1.0}}}
    for trace in (0, 1):
        line = runner.result_line(_run(), summary, cell, e2e, per_layer,
                                  trace, "NVIDIA H100 80GB HBM3")
        assert list(line)[:5] == ["correct", "attempted", "failed",
                                  "metrics", "device"]
        assert list(line)[-1] == "check"
        want = per_layer if trace else e2e
        assert set(line["metrics"]) == {m["name"] for m in want}
        for v in line["metrics"].values():
            assert set(v) == {"value", "unit"} and v["value"] > 0
        dev = line["device"]
        assert dev["platform"] == "gpu" and dev["count"] == 1
        assert ("busy_s" in dev) == bool(trace) == ("breakdown" in line)
        json.dumps(line)
    assert 0 < line["metrics"]["seeding_roofline"]["value"] < 100
