"""The reduction of a profiler trace: busy time, idle time by the host's
span, and the seeding kernels' time, on a trace made by hand."""
import json

from harness import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_time_is_split_by_the_spans_it_crosses():
    spans = [(0, 100, "batch"), (10, 20, "A"), (30, 90, "B"),
             (40, 50, "C")]
    got = trace.idle_by_span([(5, 45), (47, 100)], spans)
    assert got == {"batch": 25, "A": 10, "B": 50, "C": 8}


def test_reduce_a_hand_made_trace(tmp_path):
    ev = [
        _x("bench.window", "user_annotation", 0, 1000),
        _x("bench.batch", "user_annotation", 0, 1000),
        _x("device.seeding", "user_annotation", 100, 200),
        _x("device.seeding", "user_annotation", 300, 100),
        _x("host.traceback", "user_annotation", 500, 400),
        _x("scan_a", "kernel", 110, 50),
        _x("scan_b", "kernel", 170, 30),
        _x("k1_kernel", "kernel", 210, 40),
        _x("index_elementwise_kernel", "kernel", 260, 20),  # after K1
        _x("cub::DeviceRadixSortOnesweepKernel", "kernel", 305, 5),
        _x("diag_replay_kernel", "kernel", 320, 10),
        _x("Memcpy DtoH", "gpu_memcpy", 340, 20),
        _x("late", "kernel", 950, 100),        # runs past the window
        _x("before", "kernel", -50, 20),       # before it
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = trace.reduce(trace.load(path))
    assert r["window_s"] == 1e-3
    assert abs(r["busy_s"] - 225e-6) < 1e-12
    assert abs(r["seeding_kernel_s"] - 155e-6) < 1e-12
    assert abs(r["scan_kernel_s"] - 100e-6) < 1e-12
    assert r["device_ops"][0] == ["late", 100e-6]
    gaps = dict(r["idle_gaps"])
    assert abs(gaps["host.traceback"] - 400e-6) < 1e-12
    assert abs(sum(gaps.values()) - 775e-6) < 1e-12
