"""Timing for the port's profilers.

``loop_timer`` is the counterpart of the loop harness of
``tools/prof_scan_parts.py`` and ``tools/prof_scan_rate.py``: it runs a
stage K1 = 2 and K2 = 10 times back to back and keeps the difference of
the two runs, divided by K2 - K1. What a run pays once, whatever its
depth (the first launch's latency, the final synchronisation, the clock
reads), cancels in the difference; what is left is the stage's own time
per iteration. Where the host issues a stage's work more slowly than the
card runs it, that time is the host's.
"""
from __future__ import annotations

import subprocess
import time

import torch

K1, K2 = 2, 10
ROUNDS = 3


def device_label(device: torch.device) -> str:
    """What ran the numbers: the card's name and power limit as
    nvidia-smi prints them, or a CPU note."""
    if device.type != "cuda":
        return "cpu (plain PyTorch; no device measurement)"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = f"{torch.cuda.get_device_name(device)}, power limit unread"
    return f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"


def _elapsed_s(fn, device: torch.device) -> float:
    """Seconds that fn() takes to run to its end on ``device``."""
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) * 1e-3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def loop_timer(stage_fn, label: str, denom: float, unit: str = "Gelem/s",
               *, device: torch.device, base: torch.Tensor) -> float:
    """Time ``stage_fn(x) -> scalar tensor`` per iteration.

    Iteration k hands the stage ``(base + k) & 3`` (``base`` int8 on
    ``device``), so no two iterations of a run see the same input and a
    depth cannot reuse what the one before left in the cache; the
    results are summed and the sum is waited for. Each depth runs once
    to warm up, then three interleaved rounds keep the best difference.
    Prints the reference's line (label, ms per iteration, ``denom`` per
    second in units of 1e9 ``unit``) and returns ms per iteration."""
    device = torch.device(device)

    def run(depth):
        acc = torch.zeros((), dtype=torch.int64, device=device)
        for k in range(depth):
            acc = acc + stage_fn((base + k) & 3)
        return acc

    for depth in (K1, K2):
        _elapsed_s(lambda: run(depth), device)
    best = float("inf")
    for _ in range(ROUNDS):
        t1 = _elapsed_s(lambda: run(K1), device)
        t2 = _elapsed_s(lambda: run(K2), device)
        best = min(best, t2 - t1)
    per = best / (K2 - K1)
    rate = denom / per / 1e9 if per > 0 else float("nan")
    print(f"{label:36s} {per * 1e3:8.3f} ms/iter  {rate:8.2f} {unit}")
    return per * 1e3


def call_ms(fn, reps: int, device: torch.device) -> float:
    """Mean ms of one ``fn()`` over ``reps`` calls back to back after one
    warm-up call: CUDA events on the card (for a kernel of a few µs this
    times the host's issue of each call), ``perf_counter`` on the CPU."""
    device = torch.device(device)
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def run():
        for _ in range(reps):
            fn()
    return _elapsed_s(run, device) * 1e3 / reps


def graph_ms(fn, reps: int = 100, counted=()) -> float:
    """Device time of one ``fn()`` in ms, from a CUDA graph of ``reps``
    calls replayed once (after one warm-up replay): the host's cost of
    issuing each call is out of it. CUDA only; fn must not synchronise.

    ``counted``: kernel wrappers whose ``launches`` count their kernels
    and whose ``captured`` counts the launches recorded in a graph; each
    replay adds what this graph recorded to ``launches``."""
    fn()
    torch.cuda.synchronize()
    before = [w.captured for w in counted]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    recorded = [w.captured - n for w, n in zip(counted, before)]

    def replay():
        g.replay()
        for w, n in zip(counted, recorded):
            w.launches += n

    replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def launch_floor_ms(blocks: int) -> float:
    """``graph_ms`` of an empty kernel (csrc/launch_floor.cu) at a grid
    of ``blocks`` blocks of 256 threads (the port's kernels' block): what
    one launch alone costs in that harness whatever the kernel does. CUDA
    only (the current device)."""
    from gblastn_tpu_torch.ops import _build

    fn = _build.load().gblastn_empty_launch
    dev = torch.cuda.current_device()

    def launch():
        rc = fn(max(blocks, 1), torch._C._cuda_getCurrentRawStream(dev))
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error "
                               f"{rc}")
    return graph_ms(launch)
