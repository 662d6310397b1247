"""Reduction of a ``torch.profiler`` trace of the window.

The profiler records the device's kernels, copies and fills, and, as
annotations, the harness's own spans (``bench.window``, ``bench.batch``,
``bench.format``) and the program's ``slog`` spans (the harness opens a
``record_function`` beside each while it traces). All carry times on one
clock, in microseconds.
"""
from __future__ import annotations

import bisect
import json
import re

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
# the seeding finish's kernels (csrc/): K1, RR, G and R, and the sort in
# front of R; every other kernel of the seeding spans is the scan and
# mini-extension
FINISH = re.compile(r"k1_kernel|right_run|approx_gate|diag_replay|sort",
                    re.IGNORECASE)
TOP = 10


def load(path) -> list[dict]:
    with open(path) as fh:
        data = json.load(fh)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(holes, spans) -> dict[str, float]:
    """The idle time of ``holes`` (sorted, disjoint (start, end) pairs)
    split by the innermost span open over each part of it (the one opened
    last; "between batches" where none is)."""
    marks = sorted([(a, 1, i) for i, (a, _b, _n) in enumerate(spans)]
                   + [(b, 0, i) for i, (_a, b, _n) in enumerate(spans)]
                   + [(a, 2, -1) for a, _b in holes]
                   + [(b, -1, -1) for _a, b in holes])
    out: dict[str, float] = {}
    stack, idle, last = [], False, None
    for t, kind, i in marks:
        if idle and last is not None and t > last:
            label = spans[stack[-1]][2] if stack else "between batches"
            out[label] = out.get(label, 0.0) + (t - last)
        last = t
        if kind == 1:
            stack.append(i)
        elif kind == 0 and i in stack:
            stack.remove(i)
        elif kind == 2:
            idle = True
        elif kind == -1:
            idle = False
    return out


def reduce(events: list[dict]) -> dict | None:
    """Busy time, idle gaps by the host's span, kernel time by name, and
    the seeding spans' kernel time (all, and the scan's part), over the
    ``bench.window`` annotation (the traced stretch); None without one."""
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    win = [e for e in notes if e["name"] == "bench.window"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in dev if w0 <= float(e["ts"]) < w1]
    busy = _union([(float(e["ts"]), min(w1, float(e["ts"]) + float(e["dur"])))
                   for e in dev])
    busy_us = sum(b - a for a, b in busy)

    by_name: dict[str, float] = {}
    for e in dev:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]

    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in notes if e["name"] != "bench.window"]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    holes = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps = idle_by_span(holes, spans)

    seeding_us = scan_us = 0.0
    kernels = sorted((float(e["ts"]), float(e["dur"]), e["name"])
                     for e in dev if e.get("cat") == "kernel")
    starts = [k[0] for k in kernels]
    seeding = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in notes if e["name"] == "device.seeding")
    for bt in (e for e in notes if e["name"] == "bench.batch"):
        b0, b1 = float(bt["ts"]), float(bt["ts"]) + float(bt["dur"])
        seed = [s for s in seeding if b0 <= s[0] < b1]
        if not seed:
            continue
        s0, s1 = seed[0][0], max(s[1] for s in seed)
        mine = kernels[bisect.bisect_left(starts, s0):
                       bisect.bisect_left(starts, s1)]
        seeding_us += sum(k[1] for k in mine)
        scan_us += sum(k[1] for k in mine if not FINISH.search(k[2]))

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "seeding_kernel_s": seeding_us / 1e6,
        "scan_kernel_s": scan_us / 1e6,
        "device_ops": top(by_name),
        "idle_gaps": top(gaps),
    }
