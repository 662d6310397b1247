#!/usr/bin/env python3
"""Smoke run of gblastn_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100. It
builds the CUDA kernels from csrc/, holds each against its plain PyTorch
version on the card, drives the megablast main path end to end through
the CLI (bench config 1: 500 x 1 kb reads against a 4.6 Mb genome) with
every kernel's launch counter checked, compares the tabular bytes with
the plain-PyTorch run on the CPU, and searches one batch against a
300 Mb genome held resident. Any failure raises (exit code != 0). The
last two lines of standard output are the kernels' JSON record and the
device JSON record. Needs no network; scratch files go to
build/chip_smoke/ in the checkout.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 20260816
K1_SOURCE = "gblastn_tpu_torch/csrc/ungapped_xdrop.cu"
K1_REPLACES = "gblastn_tpu/ops/pallas_ungapped.py:161"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


class _StartRecorder:
    """numpy Generator proxy that records each read's start locus as
    bench._sample_reads draws it (the draw ``integers(0, hi)``)."""

    def __init__(self, rng, hi):
        self._rng = rng
        self._hi = hi
        self.starts = []

    def integers(self, low, high=None, *a, **k):
        v = self._rng.integers(low, high, *a, **k)
        if low == 0 and high == self._hi:
            self.starts.append(int(v))
        return v

    def random(self, *a, **k):
        return self._rng.random(*a, **k)


def sample_reads(rng, genome, num, qlen, prefix):
    """bench._sample_reads, also returning each read's source start."""
    from bench import _sample_reads

    rec = _StartRecorder(rng, len(genome) - qlen)
    reads = _sample_reads(rec, genome, num, qlen, prefix)
    check(len(rec.starts) == num, "read loci not recorded")
    return reads, rec.starts


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare_k1(args, label, card, reps):
    """K1 against its plain version on the same CUDA tensors: bit-equal
    on all five outputs. Returns (max_abs_err, ms, plain_ms)."""
    import torch

    from gblastn_tpu_torch.ops.ungapped import (
        ungapped_extend_window,
        ungapped_extend_window_ref,
    )

    got = ungapped_extend_window(*args)
    want = ungapped_extend_window_ref(*args)
    torch.cuda.synchronize()
    err = max(
        int((g.long() - w.long()).abs().max()) if g.numel() else 0
        for g, w in zip(got, want)
    )
    check(err == 0, f"K1 differs from its plain version on {label} "
                    f"(max abs err {err})")
    ms = cuda_ms(lambda: ungapped_extend_window(*args), reps)
    plain_ms = cuda_ms(lambda: ungapped_extend_window_ref(*args), 3)
    print(f"k1 {label}: n={args[3].numel()} bit-equal, kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms  [{card}]")
    return err, ms, plain_ms


def random_k1_args(device, n=32768, seed=SEED + 1):
    """A multi-subject resident db and a query with N, R, Y and
    sentinels; n random seeds (a quarter on planted matches) with walk
    budgets bounded by the query buffer and the owning subject."""
    import numpy as np
    import torch

    from gblastn_tpu_torch import FastaRecord, SequenceDB
    from gblastn_tpu_torch.engine.resident import resident_from_reference
    from gblastn_tpu_torch.engine.search import device_matrix16
    from gblastn_tpu_torch.ops.seeding import owning_subject
    from gblastn_tpu_torch.ops.ungapped import make_table64, pack_query

    rng = np.random.default_rng(seed)
    recs = [
        FastaRecord(f"s{i}", "", "".join(
            "ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(3000,
                                                                  40000)))
        ))
        for i in range(12)
    ]
    db = SequenceDB.from_records(recs, title="k1-random")
    res = resident_from_reference(db, device)
    sub2 = db.unpacked()
    qlen = 1 << 17
    q = rng.integers(0, 4, qlen).astype(np.uint8)
    planted = []
    for _ in range(200):
        so = int(rng.integers(0, db.padded_length - 600))
        qo = int(rng.integers(1, qlen - 600))
        q[qo: qo + 500] = sub2[so: so + 500]
        planted.append((qo, so))
    q[rng.integers(0, qlen, 400)] = 14      # N
    q[rng.integers(0, qlen, 200)] = 4       # R
    q[rng.integers(0, qlen, 200)] = 5       # Y
    q[::997] = 15                           # sentinels
    q[0] = 15
    soid = rng.integers(0, db.num_seqs, n)
    ss = db.starts[soid] + (rng.random(n) * db.lengths[soid]).astype(
        np.int64)
    qs = rng.integers(1, qlen - 1, n)
    k = n // 4
    pick = rng.integers(0, len(planted), k)
    for j, p in enumerate(pick):
        d = int(rng.integers(0, 500))
        qs[j] = planted[p][0] + d
        ss[j] = planted[p][1] + d
    qs_t = torch.from_numpy(qs).to(device)
    ss_t = torch.from_numpy(ss).to(device)
    oid = owning_subject(ss_t, res.starts)
    max_l = torch.minimum(torch.minimum(qs_t, ss_t),
                          ss_t - res.starts[oid]).clamp(min=0)
    max_r = torch.minimum(torch.minimum(qlen - qs_t, res.length - ss_t),
                          res.ends[oid] - ss_t).clamp(min=0)
    x = torch.from_numpy(rng.choice([16, 22, 30], n).astype(np.int32))
    q_t = torch.from_numpy(q).to(device)
    i32 = torch.int32
    return (pack_query(q_t), res.subject2,
            torch.from_numpy(make_table64(device_matrix16(1, -2))).to(
                device),
            qs_t.to(i32), ss_t.to(i32), x.to(device), max_l.to(i32),
            max_r.to(i32))


def tabular_loci_found(text, starts, qlen, slack=200):
    """Every read 'prefix{i}' has an HSP overlapping its source locus."""
    best = {}
    for line in text.splitlines():
        f = line.split("\t")
        lo, hi = sorted((int(f[8]), int(f[9])))
        best.setdefault(f[0], []).append((lo - 1, hi))
    missing = []
    for name, st in starts.items():
        spans = best.get(name, [])
        if not any(lo < st + qlen + slack and hi > st - slack
                   for lo, hi in spans):
            missing.append(name)
    return missing


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "smoke needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, str(REPO))
    import bench
    from gblastn_tpu_torch import (
        FastaRecord,
        SequenceDB,
        megablast_options,
        slog,
    )
    from gblastn_tpu_torch.cli.main import main as cli_main
    from gblastn_tpu_torch.engine.search import search, setup_batch
    from gblastn_tpu_torch.engine.seeding import ungapped_inputs
    from gblastn_tpu_torch.ops import _build
    from gblastn_tpu_torch.ops import ungapped as ung
    from gblastn_tpu_torch.ops.ungapped import ungapped_extend_window

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    print(smi)
    card = f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
    dev = torch.device("cuda:0")

    # 2. build
    t0 = time.time()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _build.load()
    print(f"build: {time.time() - t0:.1f} s")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"ptxas: {ln.strip()}")

    # config-1 workload (bench.py's recipe and seed)
    rng = np.random.default_rng(SEED)
    genome = bench._make_genome(rng, bench.GENOME_LEN)
    reads, starts = sample_reads(rng, genome, bench.NUM_QUERIES,
                                 bench.QUERY_LEN, "w0_")
    options = megablast_options(evalue=1e-5, max_target_seqs=10)
    db = SequenceDB.from_records(
        [FastaRecord("ecoli_synth", "synthetic E. coli scale genome",
                     genome)], title="ecoli_synth",
    )

    # 3. K1 against its plain version on the card
    batch = setup_batch(reads, db, options, dev)
    kw = {k: batch.seed_kw[k] for k in ("word_size", "lut_word",
                                         "scan_step", "context_offsets",
                                         "x_dropoffs")}
    _ctx, k1_args, _n = ungapped_inputs(batch.seed_dev, **kw)
    err1, ms, plain_ms = compare_k1(k1_args, "config-1 batch seeds", card,
                                    50)
    err2, _ms2, _pms2 = compare_k1(random_k1_args(dev),
                                   "random seeds, N/R/Y, 12 subjects",
                                   card, 20)
    del batch, k1_args

    # 4. config 1 end to end through the CLI
    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    (work / "genome.fa").write_text(
        ">ecoli_synth synthetic E. coli scale genome\n" + genome + "\n")
    (work / "reads.fa").write_text("".join(
        f">{r.seq_id}\n{r.sequence}\n" for r in reads))
    check(cli_main(["makedb", "-in", str(work / "genome.fa"), "-out",
                    str(work / "db"), "-title", "ecoli_synth"]) == 0,
          "makedb failed")
    blast = ["blastn", "-query", str(work / "reads.fa"), "-db",
             str(work / "db"), "-outfmt", "6", "-evalue", "1e-5",
             "-max_target_seqs", "10"]

    def run_cli(device, out):
        t = time.time()
        rc = cli_main(blast + ["-device", device, "-out", str(out)])
        torch.cuda.synchronize()
        check(rc == 0, f"blastn -device {device} exited {rc}")
        return time.time() - t

    # no fallback: a CUDA tensor must never reach the plain version
    plain = ung.ungapped_extend_window_ref

    def guarded_plain(*args):
        check(not any(a.is_cuda for a in args),
              "a CUDA tensor reached the plain K1 on the main path")
        return plain(*args)

    ung.ungapped_extend_window_ref = guarded_plain
    ungapped_extend_window.launches = 0
    t_cold = run_cli("cuda", work / "c1_cuda.tsv")
    launches = ungapped_extend_window.launches
    check(launches > 0, "K1 was not launched on the config-1 main path")
    slog.reset()
    t_warm = run_cli("cuda", work / "c1_cuda_warm.tsv")
    for ln in slog.report().splitlines()[1:]:
        print(f"stage (config1 cuda warm): {ln}")
    t_cpu = run_cli("cpu", work / "c1_cpu.tsv")
    ung.ungapped_extend_window_ref = plain
    out_cuda = (work / "c1_cuda.tsv").read_bytes()
    check(out_cuda == (work / "c1_cuda_warm.tsv").read_bytes(),
          "two cuda runs disagree")
    check(out_cuda == (work / "c1_cpu.tsv").read_bytes(),
          "config-1 tabular bytes differ between -device cuda and cpu")
    missing = tabular_loci_found(
        out_cuda.decode(), {r.seq_id: s for r, s in zip(reads, starts)},
        bench.QUERY_LEN,
    )
    check(not missing, f"reads missing their source locus: {missing[:5]}")
    n_lines = out_cuda.count(b"\n")
    nq = bench.NUM_QUERIES
    print(f"config1 cli: {nq} queries, {n_lines} tabular lines, "
          f"K1 launches {launches}; cuda cold {t_cold:.2f} s, warm "
          f"{t_warm:.2f} s = {nq / t_warm:.1f} q/s; cpu plain "
          f"{t_cpu:.2f} s; bytes equal, all {nq} loci found  [{card}]")
    del genome, db

    # 5. scale: one 500-read batch against a 300 Mb resident genome
    t0 = time.time()
    rng3 = np.random.default_rng(SEED + 3)
    big = bench._make_genome(rng3, bench.BIG_GENOME_LEN)
    big_reads, big_starts = sample_reads(rng3, big, bench.BIG_BATCH,
                                         bench.QUERY_LEN, "c")
    big_db = SequenceDB.from_records(
        [FastaRecord("chr1_synth", "synthetic chr1-scale genome", big)],
        title="chr1_synth",
    )
    del big
    t_db = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = search(big_reads, big_db, options, device=dev)
    torch.cuda.synchronize()
    t_search = time.time() - t0
    found = 0
    for q in res.queries:
        st = big_starts[q.query_index]
        if any(h.s_off < st + bench.QUERY_LEN and h.s_end > st
               for lst in q.hsplists for h in lst.hsps):
            found += 1
    check(found == len(big_reads),
          f"300 Mb: {len(big_reads) - found} reads missed their locus")
    peak = torch.cuda.max_memory_allocated()
    print(f"scale 300Mb: host db build {t_db:.1f} s, search "
          f"{t_search:.2f} s (cold, incl. resident upload) for "
          f"{len(big_reads)} reads, all loci found, peak device memory "
          f"{peak / 2**30:.2f} GiB  [{card}]")

    print(json.dumps({"kernels": [{
        "name": "ungapped_xdrop", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max(err1, err2), "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
