#!/usr/bin/env python3
"""The control of a cell's correctness check: the reference put in the
program's place with one guarantee broken, which the check must fail.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed ...]

For each seed it makes the database and the reads as a run does, takes
the reads that a run's window would search (the pool's batches after the
cold one, as many as a run compares), and writes for each the line of its
best gap-free alignment on its plant (``reference/align.py``'s
``ungapped_best``): the alignment a search without gapped extension would
report, with the configuration's scores, bit score and e-value. It then
judges those lines as a run's are judged (``harness/check.py``) and prints
each seed's ``wrong_reads_pct`` beside the cell's limit, then one JSON
line. Not part of the benchmark's runs: its readings set the limit's
upper end (``PERF.md``).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

from harness import check, data, spec  # noqa: E402
from reference.align import (  # noqa: E402
    bit_score,
    bit_score_text,
    raw_score,
    ungapped_best,
)


def control_lines(genome, reads, config, picked, device):
    """Tabular lines of the best gap-free alignment of each picked planted
    read against its plant's stretch of subject."""
    picked = [(e, i) for e, i in picked if reads.subject[i] >= 0]
    qs, ss, wins = [], [], []
    for _e, i in picked:
        k, a, b = check._window(genome, reads, i)
        qs.append(check._oriented(reads, i))
        ss.append(genome.codes(k, a, b))
        wins.append((k, a))
    best = ungapped_best(qs, ss, config["scoring"], device)
    total = float(genome.lengths.sum())
    lines = []
    for (_e, i), (k, a), (sc, q0, q1, s0, s1), q, s in zip(picked, wins,
                                                          best, qs, ss):
        if sc <= 0:
            continue
        n = int(q1 - q0)
        mm = int((q[q0:q1] != s[s0:s1]).sum())
        bits = bit_score(raw_score(sc, config["scoring"]), config["karlin"])
        ev = len(q) * total * 2.0 ** -bits
        evs = "0.0" if ev < 1e-180 else f"{ev:.0e}"
        L = len(q)
        if reads.minus[i]:
            qa, qb, sa, sb = L - q1 + 1, L - q0, a + s1, a + s0 + 1
        else:
            qa, qb, sa, sb = q0 + 1, q1, a + s0 + 1, a + s1
        lines.append("\t".join([
            check.read_id(i), genome.ids[k], f"{100.0 * (n - mm) / n:.2f}",
            str(n), str(mm), "0", str(qa), str(qb), str(sa), str(sb), evs,
            bit_score_text(bits)]))
    return lines


def reading(config, traffic, limit, seed: int, device: str) -> dict:
    """The control's check summary on ``seed``."""
    from gblastn_tpu_torch.io.seqdb import PAD

    genome = data.make_genome(config["subjects"], seed, PAD, device)
    reads = data.make_reads(genome, traffic, seed,
                            data.batch_budget(config["task"]),
                            int(traffic["pool_batches"]))
    first = np.concatenate([[0], np.cumsum(reads.batches)])
    due = [(0, i) for i in range(int(first[1]), int(first[-1]))]
    picked = check.sample(due, data.seed_words(seed))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "control.tsv"
        path.write_text("\n".join(
            control_lines(genome, reads, config, picked, device)) + "\n")
        lines_of = {0: check.parse_tabular(
            path, {check.read_id(i) for _e, i in picked})}
    verdict = check.judge(genome, reads, config, picked, lines_of, device)
    out = check.summarize(verdict, limit)
    out["seed"] = seed
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limit = spec.limits(args.workload)["wrong_reads_pct"]
    rows = []
    for seed in args.seed:
        r = reading(config, traffic, limit, seed, args.device)
        n = r["numbers"]["wrong_reads_pct"]
        print(f"control {args.workload} seed {seed}: wrong_reads_pct "
              f"{n['value']} limit {n['limit']} (compared {r['compared']}, "
              f"{r['kinds']}); correct {r['correct']}", file=sys.stderr)
        rows.append(r)
    low = min(r["numbers"]["wrong_reads_pct"]["value"] for r in rows)
    print(json.dumps({"workload": args.workload, "control_min": low,
                      "any_correct": any(r["correct"] for r in rows),
                      "readings": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
