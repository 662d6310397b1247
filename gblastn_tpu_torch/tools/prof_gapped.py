"""K2 alone: the banded gapped-DP kernel's time per launch.

The port's counterpart of ``tools/prof_gapped.py``, with its workloads
and sizes (a 4 Mb random subject, a 256 Ki query tiled from subject
fragments of 8192, 2048 seeds, rows 1024, X 50, matrix 2/-4):

  * alive: seeds on the exact tiled self-alignments, so every job runs
    all its rows (the compute-rate ceiling);
  * dead: random seed points, where every job dies in its first row
    groups (the fixed cost of a launch).

Both run through the port's K2 wrapper (``ops/gapped.py``), which reads
the subject's resident int8 codes and the query's bytes in place, in the
two-depth loop of ``tools.timing.loop_timer``; each iteration takes the
next of ten job sets whose seeds are shifted by 1..10 bases (the
reference's perturbation, which keeps the planted alignments alive); on
the card each workload is also timed as one launch alone (the first set,
a CUDA graph of 100: ``tools.timing.graph_ms``).
``--parity`` holds K2 to its plain version on the same tensors at the
reference's parity size (128 seeds, rows 256, gaps 5/2, X 37).

Run on the card:  python -m gblastn_tpu_torch.tools.prof_gapped [--parity]
On the CPU:       ... --device cpu --small   (a small size; CPU times)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from gblastn_tpu_torch.device import resolve_device
from gblastn_tpu_torch.ops.gapped import (
    NEG,
    W,
    banded_gapped_scores,
    banded_gapped_scores_ref,
    check_jobs,
    gapped_jobs,
)
from gblastn_tpu_torch.tools.timing import device_label, graph_ms, loop_timer

# The reference launched _call(..., gap_open=0, gap_extend=5) with
# _scan_steps(64, 0, 5, 2) (tools/prof_gapped.py:139, :165-168). Its
# _call takes the same convention as the port's banded_gapped_scores
# (oe = gap_open + gap_extend opens a gap, gap_extend extends it), so the
# costs pass through unchanged: megablast's greedy scoring in doubled
# units (device_gapped_params: 2r / 2p, open 0, extend r - 2p = 5).
# _scan_steps cut the TPU's horizontal-gap scan to its provable reach;
# the port's kernel cuts its own per job (ops/gapped.py::scan_reach): 13
# band positions here, a window of 4 lanes.
GAP_OPEN, GAP_EXTEND = 0, 5
X_DROP = 50
SETS = 10


def matrix(reward=2, penalty=-4):
    m = np.full((16, 4), penalty, np.int32)
    for c in range(4):
        m[c, c] = reward
    m[15, :] = NEG
    return m


def _tiled(rng, S, Q, frag):
    """The reference's subject and query: the query tiles subject
    fragments, fragment f taken from subject offset 3 f frag."""
    sub2 = rng.integers(0, 4, S).astype(np.int8)
    qbuf = np.empty(Q, np.uint8)
    for i in range(0, Q, frag):
        qbuf[i: i + frag] = sub2[i * 3: i * 3 + frag]
    return sub2, qbuf


def _jobs(q_seed, s_seed, Q, S, x, rows, dev):
    """Jobs built and checked on the host, then moved to ``dev``."""
    n = len(q_seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64))

    jobs = gapped_jobs(t(q_seed), t(s_seed), t(np.zeros(n)),
                       t(np.full(n, Q)), t(np.zeros(n)), t(np.full(n, S)),
                       torch.full((n,), x, dtype=torch.int32))
    return check_jobs(jobs, Q, S, rows).to(dev)


def parity(dev, rows=256, n=128, seed=3) -> bool:
    """The reference's parity set, K2 against its plain version."""
    rng = np.random.default_rng(seed)
    S, Q, frag = 65536, 16384, 2048
    sub2, qbuf = _tiled(rng, S, Q, frag)
    mut = rng.random(Q) < 0.05
    qbuf[mut] = rng.integers(0, 4, mut.sum())
    half = n // 2
    fr = rng.integers(0, Q // frag, half).astype(np.int64)
    off = rng.integers(16, frag - 16, half).astype(np.int64)
    q_seed = np.concatenate([fr * frag + off, rng.integers(64, Q - 64,
                                                           n - half)])
    s_seed = np.concatenate([fr * (frag * 3) + off,
                             rng.integers(64, S - 64, n - half)])
    jobs = _jobs(q_seed, s_seed, Q, S, 37, rows, dev)
    args = (torch.from_numpy(qbuf).to(dev), torch.from_numpy(sub2).to(dev),
            torch.from_numpy(matrix()).to(dev), jobs)
    kw = dict(rows=rows, gap_open=5, gap_extend=2)
    got = banded_gapped_scores(*args, **kw)
    want = banded_gapped_scores_ref(*args, **kw)
    same = (got[0] == want[0]) & (got[1] == want[1])
    n_ok = int(same.sum())
    print(f"parity: {n_ok}/{len(jobs)} jobs exact (K2 against its plain "
          f"version, {n} seeds, rows {rows})  [{device_label(dev)}]")
    return n_ok == len(jobs)


def workload(dev, small=False, n_sets=SETS):
    """The reference's workloads on ``dev``: (query, subject2, matrix,
    keywords, {"alive": job sets, "dead": job sets}), ``n_sets`` job sets
    each, seeds shifted by 1 .. n_sets bases."""
    if small:
        S, Q, frag, rows, n = 65536, 8192, 512, 16, 32
    else:
        S, Q, frag, rows, n = 4_000_000, 256 * 1024, 8192, 1024, 2048
    rng = np.random.default_rng(7)
    sub2, qbuf = _tiled(rng, S, Q, frag)
    fr = rng.integers(0, Q // frag, n).astype(np.int64)
    alive = (fr * frag + frag // 2, fr * (frag * 3) + frag // 2)
    dead = (rng.integers(64, Q - 64, n), rng.integers(64, S - 64, n))
    job_sets = {
        name: [_jobs(qs + dx, ss + dx, Q, S, X_DROP, rows, dev)
               for dx in range(1, n_sets + 1)]
        for name, (qs, ss) in (("alive", alive), ("dead", dead))}
    return (torch.from_numpy(qbuf).to(dev), torch.from_numpy(sub2).to(dev),
            torch.from_numpy(matrix()).to(dev),
            dict(rows=rows, gap_open=GAP_OPEN, gap_extend=GAP_EXTEND),
            job_sets)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gblastn_tpu_torch.tools.prof_gapped",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a small size for a CPU run")
    ap.add_argument("--parity", action="store_true",
                    help="K2 against its plain version at a small size")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_label(dev)}")
    if args.parity:
        return 0 if parity(dev) else 1
    query, subject2, mat, kw, job_sets = workload(dev, args.small)
    rows = kw["rows"]
    n = len(job_sets["alive"][0]) // 2
    tiny = torch.zeros(16, dtype=torch.int8, device=dev)
    nominal = n * W * rows * 2      # the reference's cell count
    for name, sets in job_sets.items():
        nxt = [0]

        def stage(_x):
            jobs = sets[nxt[0] % SETS]
            nxt[0] += 1
            return banded_gapped_scores(query, subject2, mat, jobs,
                                        **kw)[0].sum()

        ms = loop_timer(stage, f"{name}: K2 {2 * n} jobs, rows {rows}",
                        nominal, "Gcells/s", device=dev, base=tiny)
        if dev.type == "cuda":
            one = graph_ms(lambda: banded_gapped_scores(
                query, subject2, mat, sets[0], **kw),
                counted=(banded_gapped_scores,))
            print(f"   {one:.4f} ms one launch alone (a CUDA graph of 100)")
        score, _f, cells = banded_gapped_scores_ref(
            query, subject2, mat, sets[0], **kw, return_cells=True)
        cells = int(cells.sum())
        sc = score.cpu().numpy()
        print(f"   {ms:.4f} ms per launch; {nominal} band cells (the "
              f"reference's count, {nominal / ms / 1e6:.2f} Gcells/s), "
              f"{cells} computed with j in [0, N] "
              f"({cells / ms / 1e6:.2f} Gcells/s); right score[0..4] = "
              f"{sc[:4]} left = {sc[n:n + 4]}  [{device_label(dev)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
