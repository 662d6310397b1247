"""End-to-end stage report of bench-shaped searches.

The port's counterpart of ``tools/prof_e2e.py``: one warm-up
``search()`` and then two timed ones, each on a fresh read set drawn
with bench.py's recipe (``tools.workloads``), printing the wall time,
queries per second and the ``slog`` stage report of each timed run:
among its spans the seeding stage's ``device.seeding.pipeline`` (scan,
mini-extension and K1), ``device.seeding.finish`` (the gate G, the sorts
and the replay R, up to the one wait on the card) and
``device.seeding.fetch``, and among its values the bytes the finish
fetched (``seeding.fetch_bytes``) and the seeds G gated
(``seeding.gate_need``).

  config1   megablast, 500 x 1 kb reads against a 4.6 Mb genome
  config1w  config 1 with two-hit seeding (-window_size 40): word 28,
            LUT width 12, so the double-word probe RR runs
  config2   blastn word 11, 200 x 1.5 kb reads against the same genome
  config2w  config 2 with -window_size 40 (LUT width 11: no RR)
  config2d  dc-megablast (template 18 coding, window 40), 200 x 1.5 kb
            reads with third-position wobble (bench.py's config 2d; the
            first set is workloads.config2d_reads)
  config3   megablast, 500 x 1 kb reads against a 300 Mb genome

Run on the card:  python -m gblastn_tpu_torch.tools.prof_e2e [config1]
On the CPU:       ... --device cpu --small   (a small size; CPU times)
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from gblastn_tpu_torch.device import resolve_device
from gblastn_tpu_torch.engine.search import search
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.params.options import (
    blastn_options,
    dc_megablast_options,
    megablast_options,
)
from gblastn_tpu_torch.tools.timing import device_label
from gblastn_tpu_torch.utils.profiling import slog
from gblastn_tpu_torch.tools.workloads import (
    BIG_GENOME_LEN,
    C2_QUERIES,
    C2_QUERY_LEN,
    GENOME_LEN,
    NUM_QUERIES,
    QUERY_LEN,
    SEED,
    make_genome,
    sample_reads,
    wobble_reads,
)

CONFIGS = ("config1", "config1w", "config2", "config2w", "config2d",
           "config3")


def config_options(which: str):
    """The search options of a configuration (evalue 1e-5, 10 targets)."""
    kw = dict(evalue=1e-5, max_target_seqs=10)
    if which == "config2d":
        return dc_megablast_options(**kw)
    if which.endswith("w"):
        kw["window_size"] = 40
    make = blastn_options if which.startswith("config2") else \
        megablast_options
    return make(**kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gblastn_tpu_torch.tools.prof_e2e",
        description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default="config1",
                    choices=CONFIGS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a small size for a CPU run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = device_label(dev)
    print(f"device: {label}")
    which = args.config
    if which == "config3":
        rng = np.random.default_rng(SEED + 3)
        genome_len, prefix = BIG_GENOME_LEN, "c{}"
    else:
        rng = np.random.default_rng(SEED)
        genome_len, prefix = GENOME_LEN, "w{}_"
    n, qlen = ((C2_QUERIES, C2_QUERY_LEN) if which.startswith("config2")
               else (NUM_QUERIES, QUERY_LEN))
    if args.small:
        genome_len, n = 60_000, 4
    genome = make_genome(rng, genome_len)
    db = SequenceDB.from_records(
        [FastaRecord("synth", "synthetic genome", genome)], title=which)
    if which == "config2d":
        rng, prefix = np.random.default_rng(SEED + 6), "d"
    sets = []
    for k in range(3):
        pairs = sample_reads(rng, genome, n, qlen, prefix.format(k))[0]
        if which == "config2d":
            pairs = wobble_reads(rng, pairs)
        sets.append([FastaRecord(name, "", seq) for name, seq in pairs])
    del genome
    options = config_options(which)
    t0 = time.time()
    search(sets[0], db, options, device=dev)     # warm-up
    print(f"# warm-up {time.time() - t0:.2f}s", flush=True)
    for i, queries in enumerate(sets[1:]):
        slog.reset()
        t0 = time.time()
        res = search(queries, db, options, device=dev)
        dt = time.time() - t0
        nh = sum(len(lst.hsps) for q in res.queries for lst in q.hsplists)
        print(f"# run {i}: {dt:.3f}s = {len(queries) / dt:.1f} q/s, "
              f"{nh} HSPs  [{label}]", flush=True)
        print(slog.report(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
