#!/usr/bin/env python3
"""Smoke run of gblastn_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100. It
builds the CUDA kernels from csrc/ (one nvcc per source, all started
together; ptxas's registers and spills of each kernel, K1, G, R and RR
without a spill), holds each against its plain PyTorch version on the
card (K1, K2, G, R and RR also replayed from a CUDA graph that captured
the wrapper, which fails if the wrapper waits on the card), times K1, K2,
G, R and RR as one launch alone in a CUDA graph beside their wrapper
calls (RR also beside an empty kernel's launch at its grid, the launch
floor), prints K1's modelled lockstep lane-steps against its walk steps and the
share of the walk steps on seeds the one-hit replay saves (configs 1 and
2), holds the device finish (G, the approximate-ungapped gate, and R,
the one-hit diagonal replay) to its plain versions at configs 1 and 2
and on its random sets (a long repeat, ambiguity codes and subject ends
for G; a dense chain, identical seeds and the aliasing mask for R),
times the order R reads (``replay_keys``: one stable sort of the packed
key, which every search path must take, and the two-sort form beside
it) and holds ``run_seeding`` on the card to the host finish
``_finish_init_hits`` (InitHits field by field, the bytes fetched beside
the full fetch, the two finishes' times), checks at configs 1, 1w, 2w
and 2d that nothing in the device finish waits on the card before its
one ``nonzero`` and that an s past the bound R's sort packs it for
raises ValueError at ``run_seeding``'s one fetch, and drives the port's
paths end to end, each with
every kernel's launch counter set to 0 just before it and read just
after:

1. megablast, config 1 of bench.py (500 x 1 kb reads against a 4.6 Mb
   genome), through the CLI: K1, G and R; tabular bytes equal to the
   plain-PyTorch run on the CPU;
2. one 500-read megablast batch against a 300 Mb genome held resident;
3. blastn word 11, config 2 of bench.py (200 x 1.5 kb reads against the
   same 4.6 Mb genome), through search() with the device gapped filter
   against the same search without it, and through the CLI: K1, K2, G
   and R (no host gate or replay span on the path); tabular bytes equal
   to the CPU run;
3a. two-hit seeding at configs 1w (config 1 with -window_size 40: the
   double-word probe RR runs), 2w (config 2 with -window_size 40) and 2d
   (dc-megablast, bench.py's config 2d: 200 x 1.5 kb reads with
   third-position wobble), each with RR (1w), G and the two-hit R held to
   their plain versions (RR and the two-hit R also on their random sets)
   and run_seeding to the host finish with the window; config 2d through
   search(); configs 1w, 2w and 2d, a blastn-short and a vecscreen batch
   through the CLI: launch counters of K1, K2, G, R and RR, tabular bytes
   equal to the CPU run, reads that miss their locus counted (not a
   failure);
3b. query splitting: a second strain's assembly as one query (20 kb
   segments from random places and strands of the config-1 genome, 2%
   substitutions), 5.5 Mb with megablast and 1.2 Mb with blastn through
   the CLI, split into chunks: every segment's locus found, the segment
   across the first chunk boundary one merged HSP; tabular bytes equal to
   the CPU run at CHUNK_SIZE=1000000 on the 1.2 Mb query (megablast) and
   at CHUNK_SIZE=25000 on its first 30 kb (blastn);
3c. repeat filtering: -filtering_db with a library of 1,000 repeat
   elements of 300 bases whose copies (10-20% divergent) replace 10% of
   the genome, 500 x 1 kb reads through the CLI: the nested blastn search
   launches K1, G and R on the card, its masks equal the CPU run's, the
   tabular bytes equal the CPU run's and differ from a run without the
   filter;
3d. pipelined mode (-mode 2): 4 x 500 config-1 reads and config 2
   through the CLI, bytes equal to -mode 1's, and run_pipelined_search
   against search() on the same four batches, q/s of both;
3e. blast_formatter: config 1's -outfmt 11 archive re-rendered as
   -outfmt 6, 7 and 10 equals the direct runs;
3e'. past 2^31: K1, G, RR and R (one-hit and two-hit) against their plain
   versions on seeds of a single random subject of 2^31 + 2^22 bases
   made on the card (tools.replay_sets.past_2g_cases): RR's and R's wide
   kernels (int64 coordinates), each timed as one launch beside its
   bound, in the kernels line's entries under "past2g";
3f. giant (bench.py's config 4: one random subject of 3.2 Gbases, 100
   planted 1 kb reads, 2% substitutions) and
3g. chroms (24 random subjects of GRCh38's primary chromosome lengths,
   3.09 Gbases; 100 reads, 35 of them on chr14-chrY, past 2^31), each
   megablast through search() with the whole database resident on the
   card: every read's best hit within 64 bases of its plant, the hits
   past 2^31 counted (at least 20 on giant, 30 on chroms), run_seeding's
   InitHits equal to the host finish field by field, K1, G and R launched
   once, the -outfmt 6 rendering's sstart at each plant past 2^31; the
   resident bytes a base, the peak device memory (its part beside the
   resident form, in the allocator's reserve, within the check's
   engine.resident.SEARCH_WORK_BYTES), the process's peak RSS, the
   batch's time and its largest spans printed (run after 4);
3h. the database's masks: a mask column of 300-3,000-base intervals over
   30% of config 1's genome (makedb -mask_data), config 1 through the CLI
   with -db_soft_mask and with -db_hard_mask: cuda bytes equal cpu bytes
   and differ from the unmasked run's;
3i. indexed megablast: makembindex, then config 1 through the CLI with
   -use_index true, plain and with -db_soft_mask: cuda bytes equal cpu
   bytes and the scanned runs' bytes;
3j. two-hit seeding with -off_diagonal_range 4 at configs 1w, 2w and 2d
   through the CLI (the card runs the scan, K1, RR at 1w and G; the host
   replays across diagonals; no R): cuda bytes equal cpu bytes;
   run_seeding at 2w equal to the host finish with the scan range, field
   by field, and the host replay's time; the below-cutoff admission set
   of tests/test_oracle_parity.py through search() on the card: 0 HSPs
   at range 0, at least 8 at range 4;
3k. streaming (engine.stream): (a) config 3s, bench.py's streamed leg
   of config 3 (the 500 reads against the 300 Mb genome with
   GBLASTN_TPU_STREAM=1, blocks of 2^27): -outfmt 6 bytes equal the
   resident run's, the streamed InitHits the host finish's, K1 and G
   once a block and R once, a cold and a warm batch timed; (b) configs
   1, 1w and 2d, config 1 with -db_soft_mask and with -use_index through
   the CLI at blocks of 2^20 bases: cuda bytes equal the resident cuda
   and the cpu bytes, K1 and G a block, R a batch; (c) giant past the
   card's memory: streamed with GBLASTN_TPU_STREAM=1 for its device peak,
   held against the streamed check's need, then with no variable set
   under a ballast tensor that leaves the card between that peak and what
   the resident check demands, search() streams on its own (no resident
   upload), every read at its plant, the hits past 2^31 as resident, and
   its InitHits equal 3f's resident ones (held to the host finish) field
   by field; the launches of K1, G and R, the escalated seeds, the peak
   device memory and the time printed;
3l. sharding (parallel.dist) at GBLASTN_TPU_SHARDS=4, every shard on the
   one card: configs 1 and 2 through the CLI (bytes equal to the
   unsharded runs; K1 and G once a shard a batch, R once a batch, no K2;
   the shards uploaded by the first batch only), 1w and 2d
   (run_seeding_sharded's InitHits equal to the resident run_seeding's,
   search() equal to the unsharded search()), config 1 with six 10 kb
   reads across the three shard boundaries through search() (walks
   escalated, bytes equal), two CLI processes over gloo on localhost on
   cuda:0 (each rank's bytes equal, K1 and G twice a rank, R once), and
   the 300 Mb batch (HSPs equal to 2's, each shard's bytes, cold and
   warm times, no upload in the warm batch, peak device memory);
4. the scan profiler (gblastn_tpu_torch.tools.prof_scan_parts) in full,
   the path of the table gather P1-P3, which holds the gather bit-equal
   to its plain version and tab[idx] at the shapes of P1, P2 and P3 (and
   16 Mi probes) in both of its modes, the staged mode both on a 128 KiB
   table and on P1-P3's own 2 MiB table (split across a cluster of 16
   blocks), prints the card's limit on such clusters, sweeps the staged
   grid's cluster count, checks the staged mode's refusal of a table
   above its capacity and times each; and K2's parity check of
   tools.prof_gapped.

Any failure raises (exit code != 0). The last three lines of standard
output are the card's name and power limit, the kernels' JSON record and
the device JSON record. Needs no network; scratch files go to
build/chip_smoke/ in the checkout.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from gblastn_tpu_torch.tools.workloads import (  # bench.py's recipe, sizes
    BIG_GENOME_LEN,
    C2_QUERIES,
    C2_QUERY_LEN,
    GENOME_LEN,
    NUM_QUERIES,
    QUERY_LEN,
    SEED,
    config2d_reads,
    make_genome,
    sample_reads,
)

REPO = Path(__file__).resolve().parent
BIG_BATCH = 500

K1_SOURCE = "gblastn_tpu_torch/csrc/ungapped_xdrop.cu"
K1_REPLACES = "gblastn_tpu/ops/pallas_ungapped.py:161"
K2_SOURCE = "gblastn_tpu_torch/csrc/gapped_band.cu"
K2_REPLACES = "gblastn_tpu/ops/pallas_gapped.py:83"
GATHER_SOURCE = "gblastn_tpu_torch/csrc/table_gather.cu"
GATHER_REPLACES = "tools/prof_scan_parts.py:164,183,203"
G_SOURCE = "gblastn_tpu_torch/csrc/approx_gate.cu"
G_REPLACES = "gblastn_tpu/ops/seeding.py:908"
R_SOURCE = "gblastn_tpu_torch/csrc/diag_replay.cu"
R_REPLACES = "gblastn_tpu/ops/seeding.py:1013"
RR_SOURCE = "gblastn_tpu_torch/csrc/right_run.cu"
RR_REPLACES = "gblastn_tpu/ops/seeding.py:729"

# The card's peak rates for the bounds (NVIDIA H100 SXM data sheet at
# 700 W): 3.35 TB/s of HBM, and int32 outside the tensor cores at 64
# INT32 lanes per SM x 132 SMs x 1.98 GHz boost = 16.7 Tops/s (half the
# float32 lanes behind the sheet's 67 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 operations the recurrences need per unit of work (loads, address
# arithmetic and loop control not counted; the tallies are in the notes of
# csrc/ungapped_xdrop.cu and csrc/gapped_band.cu):
K1_OPS_PER_STEP = 9       # score 3, sum 1, drop test 2, best and its step 3
K2_OPS_PER_CELL = 18      # diag 1, Ht 1, u 3, scan 1, E 3, H 1, thr 2,
                          # live 1, F 4, best 1; cells with j in [0, N]
G_OPS_PER_STEP = 5        # XOR 1, sum 1, reset test 1, reset update 1,
                          # drop test 1; byte-steps of the walks
RR_OPS_PER_BASE = 6       # two extracts (shift, mask) 4, compare 1,
                          # count 1; each base a run compares (its length,
                          # and one more where it stops short of the word)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes, ops):
    """(least ms, what sets it) for this many bytes (each input read
    once, each output written once) and int32 ops."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def span_bytes(lo, hi):
    """The length of the union of the half-open ranges [lo, hi) (int64
    tensors): the distinct bytes of an array that walks from lo to hi
    read."""
    import torch

    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    if not lo.numel():
        return 0
    order = torch.argsort(lo)
    lo, hi = lo[order], hi[order]
    reach = torch.cummax(hi, 0).values
    start = torch.maximum(lo[1:], reach[:-1])
    return int(hi[0] - lo[0]) + int((hi[1:] - start).clamp(min=0).sum())


def _kernel_name(mangled):
    """The shortest name '<len><name>' ending in '_kernel' inside a
    mangled symbol, else the symbol. (The anonymous namespace's hash may
    hold digits that read as the length of a longer name ending at the
    same place.)"""
    names = []
    for i, ch in enumerate(mangled):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
            name = mangled[j: j + int(mangled[i:j])]
            if name.endswith("_kernel") and name.isidentifier():
                names.append(name)
    return min(names, key=len, default=mangled)


def ptxas_kernels(log):
    """(source, kernel, registers, spill stores, spill loads) of every
    entry function in nvcc's -Xptxas=-v output (``_build.build_log``,
    whose sources open with '== name')."""
    out, src, fn, spill = [], None, None, (0, 0)
    for ln in log.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
        elif "Compiling entry function" in ln:
            m = re.search(r"'([^']+)'", ln)
            fn, spill = _kernel_name(m.group(1) if m else "?"), (0, 0)
        elif "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            spill = (int(m.group(1)), int(m.group(2))) if m else (0, 0)
        elif "Used" in ln and "registers" in ln and fn is not None:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            out.append((src, fn, regs, *spill))
            fn = None
    return out


def compare_k1(args, label, card, reps):
    """K1 against its plain version on the same CUDA tensors: bit-equal
    on all five outputs, with no seed flagged out of range, also when
    replayed from a CUDA graph that captured the wrapper's call (the
    capture fails if the wrapper waits on the card); one launch alone
    from that graph and a wrapper call timed back to back. Prints the
    modelled lockstep lane-steps against the plain version's walk steps.
    Returns a dict, with the seeds (q_off, s_off) and the plain version's
    walk steps for ``compare_finish``'s share of them on saved seeds."""
    import torch

    from gblastn_tpu_torch.ops import ungapped as ung
    from gblastn_tpu_torch.tools.timing import call_ms, graph_ms

    k1 = ung.ungapped_extend_window
    n = args[3].numel()
    *want, steps = ung.ungapped_extend_window_ref(*args, return_steps=True)
    got = k1(*args)
    ung.check_flags(got[4])
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    check(err == 0, f"K1 differs from its plain version on {label} "
                    f"(max abs err {err})")
    last = []

    def launch():
        last[:] = k1(*args)
    ms_graph = graph_ms(launch, counted=(k1,))
    torch.cuda.synchronize()
    check(all(torch.equal(o, w) for o, w in zip(last, want)),
          f"K1 replayed from a CUDA graph differs on {label}")
    ms = call_ms(lambda: k1(*args), reps, "cuda")
    plain_ms = call_ms(lambda: ung.ungapped_extend_window_ref(*args), 3,
                       "cuda")
    walk = int(steps.sum())
    lanes = ung.lockstep_lane_steps(steps)
    # query, table and the seeds in, and the subject bytes the walks
    # read; 4 int32 and an int64 (s_start) per seed out
    s0 = args[4].long()
    read = span_bytes(s0 - steps[0], s0 + steps[1])
    bound_ms, by = bound(nbytes(args[0], *args[2:]) + read + 24 * n,
                         K1_OPS_PER_STEP * walk)
    print(f"k1 {label}: n={n} seeds, {walk} walk steps, bit-equal (also "
          f"from a graph); one launch {ms_graph:.4f} ms, a call {ms:.4f} "
          f"ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}); "
          f"lockstep lane-steps (model) {lanes} ({100 * walk / lanes:.0f}% "
          f"busy)  [{card}]")
    return {"err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "ms_graph": ms_graph,
            "seeds": (args[3], args[4]), "steps": steps}


def compare_k2(args, kw, label, card, reps):
    """K2 against its plain version on the same CUDA tensors: bit-equal
    on score and flags of every job, also after replaying the wrapper's
    call captured in a CUDA graph (the capture fails if the wrapper waits
    on the card); a wrapper call timed back to back and one launch alone
    from the graph. Returns (max_abs_err, ms, plain_ms, bound_ms,
    bound_by, ms_graph)."""
    import torch

    from gblastn_tpu_torch.ops.gapped import (
        FLAG_EDGE,
        FLAG_ROWS,
        banded_gapped_scores,
        banded_gapped_scores_ref,
    )
    from gblastn_tpu_torch.tools.timing import call_ms, graph_ms

    got = banded_gapped_scores(*args, **kw)
    ws, wf, cells = banded_gapped_scores_ref(*args, **kw,
                                             return_cells=True)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, (ws, wf)))
    check(err == 0, f"K2 differs from its plain version on {label} "
                    f"(max abs err {err})")
    ms = call_ms(lambda: banded_gapped_scores(*args, **kw), reps, "cuda")
    last = []

    def launch():
        last[:] = banded_gapped_scores(*args, **kw)

    ms_graph = graph_ms(launch, counted=(banded_gapped_scores,))
    torch.cuda.synchronize()
    check(torch.equal(last[0], ws) and torch.equal(last[1], wf),
          f"K2 replayed in a CUDA graph differs on {label}")
    plain_ms = call_ms(lambda: banded_gapped_scores_ref(*args, **kw), 2,
                       "cuda")
    jobs = args[3]
    J = len(jobs)
    cells = int(cells.sum())
    # query, subject, matrix and 28 bytes per job in; 8 per job out
    bound_ms, by = bound(
        nbytes(*args[:3], jobs.a0, jobs.b0, jobs.m, jobs.n, jobs.x) + 8 * J,
        K2_OPS_PER_CELL * cells)
    f = wf.cpu().numpy()
    n_edge = int(((f & FLAG_EDGE) != 0).sum())
    n_rows = int(((f & FLAG_ROWS) != 0).sum())
    empty = int(((jobs.m <= 0) | (jobs.n <= 0)).sum())
    print(f"k2 {label}: {J} jobs ({empty} empty), rows {kw['rows']}, "
          f"{cells} cells (j in [0, N]) computed, flagged edge {n_edge} / rows "
          f"{n_rows}, bit-equal (also from a graph), kernel {ms:.4f} ms a "
          f"call, {ms_graph:.4f} ms one launch, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({by})  [{card}]")
    return err, ms, plain_ms, bound_ms, by, ms_graph


def _timed(fn, args, kw, counted, want, label, what, reps):
    """fn(*args, **kw) bit-equal to ``want`` (a tuple of tensors), also
    replayed from a CUDA graph that captured the wrapper (the capture
    fails if it waits on the card); (max abs err, one launch alone in ms
    from the graph, a call in ms)."""
    import torch

    from gblastn_tpu_torch.tools.timing import call_ms, graph_ms

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    got = tup(fn(*args, **kw))
    torch.cuda.synchronize()
    err = max((int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want)), default=0)
    check(err == 0, f"{what} differs from its plain version on {label} "
                    f"(max abs err {err})")
    last = []

    def launch():
        last[:] = tup(fn(*args, **kw))
    ms_graph = graph_ms(launch, counted=counted)
    torch.cuda.synchronize()
    check(all(torch.equal(o, w) for o, w in zip(last, want)),
          f"{what} replayed from a CUDA graph differs on {label}")
    return err, ms_graph, call_ms(lambda: fn(*args, **kw), reps, "cuda")


def compare_gate(args, kw, label, card, reps):
    """G against its plain version on the same CUDA tensors (all five
    outputs, no seed flagged out of range), one launch alone and a call
    timed; the gated and demoted seeds and the byte-steps of their walks
    (the plain version's count). Returns a dict."""
    import torch

    from gblastn_tpu_torch.ops import replay as rp
    from gblastn_tpu_torch.tools.timing import call_ms

    *want, steps = rp.approx_gate_ref(*args, **kw, return_steps=True)
    rp.check_gate_flags(want[4])
    err, ms_graph, ms = _timed(rp.approx_gate, args, kw, (rp.approx_gate,),
                               tuple(want), label, "G", reps)
    plain_ms = call_ms(lambda: rp.approx_gate_ref(*args, **kw), 2, "cuda")
    n = args[6].numel()
    f = want[4]
    need = int(((f & rp.FLAG_NEED) != 0).sum())
    dem = int(((f & rp.FLAG_DEMOTE) != 0).sum())
    walk = int(steps.sum())
    longest = int(steps.sum(0).max()) if n else 0
    # the query, tables and the seeds in, and the packed subject bytes
    # the walks read (from the seed's byte, to within one); 4 int32 and
    # an int64 (s_start) a seed out
    sb = args[7].long() >> 2
    read = span_bytes(sb - steps[0], sb + steps[1] + 1)
    bound_ms, by = bound(nbytes(args[0], *args[2:]) + read + 24 * n,
                         G_OPS_PER_STEP * walk)
    print(f"G {label}: n={n} seeds, {need} gated, {dem} demoted, {walk} "
          f"byte-steps (longest walk {longest}), bit-equal (also from a "
          f"graph); one launch {ms_graph:.4f} ms, a call {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by})  [{card}]")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "ms_graph": ms_graph,
            "bound_ms": bound_ms, "bound_by": by, "need": need,
            "demoted": dem, "byte_steps": walk}


def compare_replay(args, kw, label, card, reps, keys=None):
    """R against its plain version on the same CUDA tensors, one launch
    alone and a call timed; the segments (runs of equal ``key >>
    key_shift``) and the longest; with ``keys`` = ``replay_keys``' (args,
    kw) its two forms that order the seeds timed beside it: one stable
    sort of the packed key and two stable sorts. Returns a dict."""
    import torch

    from gblastn_tpu_torch.ops import replay as rp
    from gblastn_tpu_torch.tools.timing import call_ms

    want = rp.diag_replay_ref(*args, **kw)
    err, ms_graph, ms = _timed(rp.diag_replay, args, kw, (rp.diag_replay,),
                               (want,), label, "R", reps)
    runs = kw.get("right_run") if kw.get("window") else None
    plain_ms = call_ms(lambda: rp.diag_replay_ref(*args, **kw), 2, "cuda")
    n = args[0].numel()
    counts = torch.unique_consecutive(args[0] >> kw.get("key_shift", 0),
                                      return_counts=True)[1]
    # the long segments (32 seeds or more): their median seed count and
    # median span in bases (a segment's s ascends)
    ends = torch.cumsum(counts, 0)
    s_sorted = args[2][args[1]].long()
    long_ = counts >= 32
    spans = s_sorted[ends[long_] - 1] - s_sorted[(ends - counts)[long_]]
    long_note = (f"{int(long_.sum())} of 32 seeds or more (median "
                 f"{int(counts[long_].median())} seeds over "
                 f"{int(spans.median())} bases)" if long_.any() else
                 "none of 32 seeds or more")
    sort_ms = sort_two_ms = None
    if keys is not None:
        sort_ms = call_ms(lambda: rp.replay_keys(*keys[0], **keys[1]), reps,
                          "cuda")
        sort_two_ms = call_ms(lambda: rp.replay_keys(
            *keys[0], **keys[1], two_sorts=True), reps, "cuda")
    # sorted keys and order, the four per-seed arrays read (and two-hit's
    # runs); a byte a seed written
    bound_ms, by = bound(nbytes(*args) + n + (4 * n if runs is not None
                                               else 0), 0)
    note = (f", replay_keys: one sort {sort_ms:.4f} ms a call (key_shift "
            f"{kw['key_shift']}), two sorts {sort_two_ms:.4f}"
            if sort_ms is not None else "")
    if kw.get("window"):
        note += (f"; two-hit, window {kw['window']}, runs "
                 f"{'from RR' if runs is not None else '0 (rr_zero)'}")
    print(f"R {label}: n={n} seeds in {counts.numel()} segments (longest "
          f"{int(counts.max()) if n else 0}; {long_note}), "
          f"{int(want.sum())} saved, "
          f"bit-equal (also from a graph); one launch {ms_graph:.4f} ms, a "
          f"call {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} "
          f"ms ({by}){note}  [{card}]")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "ms_graph": ms_graph,
            "bound_ms": bound_ms, "bound_by": by, "sort_ms": sort_ms,
            "sort_two_ms": sort_two_ms, "saved": int(want.sum()),
            "saved_mask": want}


def rr_work(args, word, run):
    """(bytes, compares): the work RR must do for the seeds of ``args``
    (``right_run``'s) whose runs are ``run``. The compares are each base
    a run compares: its length, and one more where it stops short of its
    limit. The bytes are 16 a seed (q_off, s_off and oid read, the run
    written), 8 for each owning subject's end a seed reads, and 8 for
    each query or subject word that holds a base a run compares (from the
    word end through the base that stops it short of its limit, as the
    kernel loads them), each word counted once however many seeds share
    it."""
    import torch

    query_nib, subject_w, sub_ends, q_off, s_off, oid = args
    q, s, o = q_off.long() + word, s_off.long() + word, oid.long()
    n_sub = sub_ends.numel()
    ok = (o >= 0) & (o < n_sub)
    hi = torch.where(ok, sub_ends.long()[o.clamp(0, max(n_sub - 1, 0))], 0)
    lim = torch.minimum(torch.minimum(torch.full_like(q, word),
                                      8 * query_nib.numel() - q),
                        hi.clamp(max=16 * subject_w.numel()) - s)
    lim = torch.where(ok & (q >= 0) & (s >= 0), lim, 0)
    run = run.long()
    short = run < lim
    last = torch.where(short, run, run - 1)     # the last base compared
    total = 16 * q_off.numel() + 8 * torch.unique(o[ok]).numel()
    for pos, per in ((q, 8), (s, 16)):
        w = (pos // per)[:, None] + torch.arange(-(-word // per) + 1,
                                                 device=pos.device)
        held = (lim > 0)[:, None] & (w <= ((pos + last) // per)[:, None])
        total += 8 * torch.unique(w[held]).numel()
    return total, int(run.sum()) + int(short.sum())


def compare_run(args, kw, label, card, reps):
    """RR against its plain version on the same CUDA tensors (also
    replayed from a CUDA graph that captured the wrapper), one launch
    alone and a call timed, and an empty kernel's launch at the same grid
    (the launch floor) in the same harness; the runs' spread. Returns a
    dict."""
    import torch

    from gblastn_tpu_torch.ops import replay as rp
    from gblastn_tpu_torch.tools.timing import call_ms, launch_floor_ms

    want = rp.right_run_ref(*args, **kw)
    err, ms_graph, ms = _timed(rp.right_run, args, kw, (rp.right_run,),
                               (want,), label, "RR", reps)
    plain_ms = call_ms(lambda: rp.right_run_ref(*args, **kw), 2, "cuda")
    n = args[3].numel()
    floor_ms = launch_floor_ms(-(-n // 256))
    W = kw["word_size"]
    moved, compares = rr_work(args, W, want)
    bound_ms, by = bound(moved, RR_OPS_PER_BASE * compares)
    hist = torch.bincount(want.long(), minlength=W + 1).tolist()
    print(f"RR {label}: n={n} seeds, word {W}, runs 0: {hist[0]}, 1..{W - 1}:"
          f" {sum(hist[1:W])}, {W} (double words): {hist[W]}; {compares} "
          f"base compares, {moved} bytes needed (of {nbytes(*args) + 4 * n}"
          f" in all the inputs and the output), bit-equal (also from a "
          f"graph); one launch "
          f"{ms_graph:.4f} ms (an empty kernel at the same grid "
          f"{floor_ms:.4f} ms), a call {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({by})  [{card}]")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "ms_graph": ms_graph,
            "bound_ms": bound_ms, "bound_by": by, "double_words": hist[W],
            "launch_floor_ms": floor_ms}


def host_init(batch):
    """(InitHits, seconds, K1 seeds, raw seeds): the host finish
    ``_finish_init_hits`` over the full fetch of K1's rows of a resident
    one-hit ``batch`` (scan and K1 on its device), the InitHits its
    device finish is held to; the seconds are the host finish's alone."""
    from gblastn_tpu_torch.engine.seeding import (
        _finish_init_hits,
        ungapped_inputs,
    )
    from gblastn_tpu_torch.ops.ungapped import ungapped_extend_window

    kw, okw = batch.seed_kw, batch.oracle_kw
    ctx, k1_args, n_raw = ungapped_inputs(batch.seed_dev, **kw)
    ung = ungapped_extend_window(*k1_args)
    rows = [t.cpu().numpy() for t in (k1_args[3], k1_args[4], ctx,
                                      *ung[:4])]
    n_ctx = len(kw["x_dropoffs"])
    t0 = time.time()
    want = _finish_init_hits(
        *rows, okw["word_cutoffs"], okw["subject_starts"], kw["word_size"],
        concat_qlen=int(kw["context_offsets"][n_ctx]) - 2,
        approx_ctx=okw["approx_ctx"])
    return want, time.time() - t0, len(rows[0]), n_raw


def same_init(got, want, what):
    """Fails unless two InitHits agree field by field."""
    for name in ("q_off", "s_off", "q_start", "s_start", "length", "score",
                 "context", "oid"):
        check(np.array_equal(getattr(got, name), getattr(want, name)),
              f"{what}: the InitHits' {name} differ")


def compare_finish(batch, label, card, reps, k1=None):
    """G and R at a batch's search-path inputs against their plain
    versions (compare_gate, compare_replay), then ``run_seeding`` on the
    card against the host finish ``_finish_init_hits`` over the full
    fetch of K1's rows: InitHits equal field by field. Prints the saved
    seeds, the gated ones, the bytes the device finish fetched and those
    the parent's full fetch took, both finishes' times and, with ``k1``
    (compare_k1's record for the same batch), the share of K1's walk
    steps that fall on the seeds R saves. Returns (G record, R
    record)."""
    import torch

    from gblastn_tpu_torch import slog
    from gblastn_tpu_torch.engine.seeding import (
        _finish_init_hits,
        compute_right_runs,
        probes_double_words,
        run_seeding,
    )
    from gblastn_tpu_torch.tools.replay_sets import (
        batch_cases,
        batch_key_case,
    )

    g_args, g_kw, r_args, r_kw = batch_cases(batch)
    window = r_kw["window"]
    keys = batch_key_case(batch, g_args, g_kw, r_args)
    check(r_kw["key_shift"] > 0, f"replay_keys took two sorts on {label}")
    g = compare_gate(g_args, g_kw, label, card, reps)
    r = compare_replay(r_args, r_kw, label, card, reps, keys=keys)
    kw, okw = batch.seed_kw, batch.oracle_kw
    n_ctx = len(kw["x_dropoffs"])
    n = g_args[6].numel()
    run_seeding(batch.seed_dev, **kw)                 # warm-up
    torch.cuda.synchronize()
    slog.reset()
    t0 = time.time()
    got = run_seeding(batch.seed_dev, **kw)
    t_dev = time.time() - t0
    spans = dict(slog.totals)
    fetched = int(slog.values["seeding.fetch_bytes"])
    need = int(slog.values["seeding.gate_need"])
    # the host finish on the full fetch of K1's rows (the parent's path),
    # with two-hit seeding the host's own right runs
    rows = torch.stack([t.long() for t in (*g_args[6:9], *g_args[10:14])]
                       ).cpu().numpy()
    t0 = time.time()
    runs = None
    if window:
        res = batch.seed_dev.resident
        runs = (compute_right_runs(
            okw["approx_ctx"]["query"], res.subject2.cpu().numpy(),
            res.valid.cpu().numpy(), rows[0], rows[1], kw["word_size"])
            if probes_double_words(batch.seed_dev, kw)
            else np.zeros(n, np.int32))
    want = _finish_init_hits(
        *rows, okw["word_cutoffs"], okw["subject_starts"], kw["word_size"],
        concat_qlen=int(kw["context_offsets"][n_ctx]) - 2,
        approx_ctx=okw["approx_ctx"], window_size=window, right_run=runs)
    t_host = time.time() - t0
    if g_kw["right_run"] is not None:
        check(np.array_equal(g_kw["right_run"].cpu().numpy(), runs),
              f"RR's runs differ from compute_right_runs on {label}")
    for name in ("q_off", "s_off", "q_start", "s_start", "length", "score",
                 "context", "oid"):
        check(np.array_equal(getattr(got, name), getattr(want, name)),
              f"run_seeding's {name} differs from the host finish on {label}")
    check(need == g["need"], f"run_seeding gated {need} seeds, G {g['need']}")
    note = ""
    if k1 is not None:
        check(all(torch.equal(a, b) for a, b in zip(k1["seeds"],
                                                     g_args[6:8])),
              f"K1's seeds differ between two scans of {label}")
        saved = r["saved_mask"].to(k1["steps"].device).bool()
        steps = k1["steps"]
        share = int(steps[:, saved].sum()) / max(int(steps.sum()), 1)
        note = (f"; the {int(saved.sum())} seeds R saves hold "
                f"{100 * share:.1f}% of K1's walk steps")
    print(f"init hits {label}: {len(got)} saved of {n} K1 seeds ({need} "
          f"gated), equal field by field to the host finish; run_seeding "
          f"{t_dev * 1e3:.1f} ms (pipeline "
          f"{spans['device.seeding.pipeline'] * 1e3:.1f}, finish "
          f"{spans['device.seeding.finish'] * 1e3:.1f}, fetch "
          f"{spans['device.seeding.fetch'] * 1e3:.2f} ms), fetched {fetched} "
          f"bytes (the full fetch of K1's rows: {40 * n}); the host finish "
          f"on that fetch {t_host * 1e3:.1f} ms{note}  [{card}]")
    return g, r


def check_finish_guards(batch, label, card):
    """Two promises of the device finish on the card, at a batch's search
    path: nothing in it waits on the card before its one ``nonzero``
    (``device_finish`` runs under ``torch.cuda.set_sync_debug_mode
    ("error")``, which raises at any operation that synchronises; the
    ``nonzero`` after it must raise there, which shows the mode is on),
    and a subject-local s past the bound the sort packs it for (the
    batch's longest subject, cut to 100 bases) raises ValueError at
    ``run_seeding``'s one fetch, from the sort's range flag."""
    import torch

    from gblastn_tpu_torch.engine import seeding as es
    from gblastn_tpu_torch.ops.ungapped import ungapped_extend_window

    dev, kw = batch.seed_dev, batch.seed_kw
    ctx, k1_args, _n = es.ungapped_inputs(dev, **kw)
    ung = ungapped_extend_window(*k1_args)
    torch.cuda.synchronize()
    waited = False
    torch.cuda.set_sync_debug_mode("error")
    try:
        _rows, head, saved = es.device_finish(dev, k1_args, ctx, ung, kw)
        try:
            torch.nonzero(saved)
        except RuntimeError:
            waited = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(waited, "the sync debug mode did not stop the nonzero")
    check(int(head[3]) == 0, f"the sort's range flag is set on {label}")
    res = dev.resident
    longest, res.longest = res.longest, 100
    raised = ""
    try:
        es.run_seeding(dev, **kw)
    except ValueError as e:
        raised = str(e)
    finally:
        res.longest = longest
    check("s outside the bounds" in raised,
          f"an s past the sort's bound did not raise on {label}: {raised!r}")
    print(f"finish guards {label}: nothing waits before the nonzero "
          f"(sync debug mode 'error'); an s past the sort's bound raised "
          f"at the fetch: {raised}  [{card}]")


def finish_entry(name, source, replaces, recs, launches, by_path,
                 registers, main="config2", sorts=None):
    """The kernels line's right_run, approx_gate or diag_replay entry:
    the ``main`` record's times and bound (config 2's; config 1w's for
    RR), the other records' beside them (and each record's launch floor,
    where it has one); with ``sorts`` (a compare_replay record)
    ``replay_keys``' one-sort and two-sort times as ``sort_ms`` and
    ``sort_ms_two_sorts``."""
    c2 = recs[main]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(r["err"] for r in recs.values()),
             "ms": c2["ms"], "plain_ms": c2["plain_ms"],
             "bound_ms": c2["bound_ms"], "bound_by": c2["bound_by"],
             "library_ms": None, "ms_graph": c2["ms_graph"],
             "registers": registers, "launches_by_path": by_path}
    if "launch_floor_ms" in c2:
        entry["launch_floor_ms"] = c2["launch_floor_ms"]
    if sorts is not None:
        entry["sort_ms"] = sorts["sort_ms"]
        entry["sort_ms_two_sorts"] = sorts["sort_two_ms"]
    for tag, r in recs.items():
        if tag != main:
            entry.update({f"{k}_{tag}": r[k] for k in (
                "ms", "plain_ms", "bound_ms", "ms_graph", "launch_floor_ms")
                if k in r})
    return entry


def k1_entry(c2, c1, rand, launches, by_path, registers, extra=None):
    """The kernels line's ungapped_xdrop entry from compare_k1's records:
    config 2's times and bound, config 1's, the random set's and those of
    ``extra`` ({tag: record}) beside them, and ptxas's registers."""
    entry = {"name": "ungapped_xdrop", "route": "cuda",
             "source": K1_SOURCE, "replaces": K1_REPLACES,
             "launches": launches,
             "max_abs_err": max(c2["err"], c1["err"], rand["err"]),
             "ms": c2["ms"], "plain_ms": c2["plain_ms"],
             "bound_ms": c2["bound_ms"], "bound_by": c2["bound_by"],
             "library_ms": None, "ms_graph": c2["ms_graph"],
             "registers": registers, "launches_by_path": by_path}
    for tag, r in (("config1", c1), ("random", rand),
                   *(extra or {}).items()):
        entry.update({f"{k}_{tag}": r[k] for k in (
            "ms", "plain_ms", "bound_ms", "ms_graph")})
        entry["max_abs_err"] = max(entry["max_abs_err"], r["err"])
    return entry


def gather_entry(recs, launches, sweep=None):
    """The kernels line's table_gather entry from prof_scan_parts' records:
    times and bound at P3's shape in the global mode, the other shapes
    and the staged mode (on the 128 KiB table and on the 2 MiB PV, keys
    ``*_staged`` and ``*_staged_pv``) beside them, and the staged grid's
    cluster sweep (one launch alone, ms by cluster count)."""
    p3 = recs["p3_global"]
    entry = {"name": "table_gather", "route": "cuda",
             "source": GATHER_SOURCE, "replaces": GATHER_REPLACES,
             "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
             "ms": p3["ms"], "plain_ms": p3["plain_ms"],
             "bound_ms": p3["bound_ms"], "bound_by": p3["bound_by"],
             "library_ms": p3["library_ms"], "ms_graph": p3["ms_graph"],
             "library_ms_graph": p3["library_ms_graph"],
             "launches_by_path": {"prof_scan_parts": launches}}
    for key, r in recs.items():
        if key != "p3_global":
            tag = key.replace("huge", "16mi")
            entry.update({f"ms_{tag}": r["ms"],
                          f"library_ms_{tag}": r["library_ms"],
                          f"ms_graph_{tag}": r["ms_graph"],
                          f"library_ms_graph_{tag}": r["library_ms_graph"],
                          f"bound_ms_{tag}": r["bound_ms"]})
    if sweep:
        entry["sweep_ms_graph"] = {
            key.replace("huge", "16mi"): {
                "rule": w["rule"], "max": w["max"],
                "ms": {str(c): ms for c, ms in w["ms"].items()}}
            for key, w in sweep.items()}
    return entry


def random_k1_args(device, n=32768, seed=SEED + 1):
    """A multi-subject resident db and a query with N, R, Y and
    sentinels; n random seeds (a quarter on planted matches) with walk
    budgets bounded by the query buffer and the owning subject."""
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
            qs_t.to(i32), ss_t, x.to(device), max_l.to(i32),
            max_r.to(i32))


def random_k2_cases(device, n=4096, seed=SEED + 5):
    """K2 jobs on a random subject and query with planted stretches (3%
    mutated; every third with a 70-base insertion, past the band's half
    width), N bases, empty jobs (M or N = 0) and a short row budget, for
    both scorings as device_gapped_params gives them: blastn DP 2/-3,
    gaps 5/2, X = gap_x_dropoff; megablast greedy in doubled units, open
    0, extend 5, X = 2 gap_x_dropoff. Yields (label, args, kw)."""
    import torch

    from gblastn_tpu_torch import blastn_options, megablast_options
    from gblastn_tpu_torch.engine.gapped import device_gapped_params
    from gblastn_tpu_torch.ops.gapped import check_jobs, gapped_jobs

    rng = np.random.default_rng(seed)
    S, Q = 2_000_000, 1_000_000
    sub = rng.integers(0, 4, S).astype(np.int8)
    q = rng.integers(0, 4, Q).astype(np.uint8)
    qs = rng.integers(3000, Q - 3000, n)
    ss = rng.integers(3000, S - 3000, n)
    for k in range(0, n, 2):
        L = int(rng.integers(200, 1200))
        seg = sub[ss[k]: ss[k] + L].astype(np.uint8).copy()
        mut = rng.random(L) < 0.03
        seg[mut] = rng.integers(0, 4, int(mut.sum()))
        if k % 6 == 0:
            seg = np.concatenate([seg[:L // 3], rng.integers(
                0, 4, 70).astype(np.uint8), seg[L // 3:]])
        q[qs[k]: qs[k] + len(seg)] = seg
    q[rng.random(Q) < 0.01] = 14
    q_lo = np.maximum(qs - rng.integers(0, 2000, n), 0)
    q_hi = np.minimum(qs + rng.integers(0, 2000, n), Q)
    s_lo = np.maximum(ss - rng.integers(0, 2000, n), 0)
    s_hi = np.minimum(ss + rng.integers(0, 2000, n), S)
    q_hi[1::7] = qs[1::7]
    s_lo[2::9] = ss[2::9]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    h = torch.from_numpy
    for name, opts, gxd in (("blastn", blastn_options(), 33),
                            ("megablast", megablast_options(), 27)):
        mat, _dbl, go, ge, xd = device_gapped_params(opts, gxd)
        x = np.where(rng.random(n) < 0.1, 400, xd).astype(np.int32)
        jobs = check_jobs(gapped_jobs(h(qs), h(ss), h(q_lo), h(q_hi),
                                      h(s_lo), h(s_hi), h(x)),
                          Q, S, 512).to(device)
        yield (f"random {name} jobs", (t(q), t(sub), t(mat), jobs),
               dict(rows=512, gap_open=go, gap_extend=ge))


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


def hsp_rows(res):
    """Every HSP of a search result, all fields, in result order."""
    def fields(h):
        return tuple((k, list(v) if k == "edit_script" and v is not None
                      else v) for k, v in vars(h).items())

    return [(q.query_index, lst.oid, lst.best_evalue, fields(h))
            for q in res.queries for lst in q.hsplists for h in lst.hsps]


def main() -> int:
    import torch

    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "smoke needs a CUDA card", file=sys.stderr)
        return 2

    sys.path.insert(0, str(REPO))
    from gblastn_tpu_torch import (
        FastaRecord,
        SequenceDB,
        blastn_options,
        megablast_options,
        slog,
    )
    from gblastn_tpu_torch.cli.main import main as cli_main
    from gblastn_tpu_torch.engine.gapped import gapped_filter_jobs
    from gblastn_tpu_torch.engine.search import (
        _build_gapped_filter,
        search,
        setup_batch,
    )
    from gblastn_tpu_torch.engine.seeding import run_seeding, ungapped_inputs
    from gblastn_tpu_torch.io.fasta import (
        BATCH_SIZE_BLASTN,
        BATCH_SIZE_MEGABLAST,
        batch_records,
    )
    from gblastn_tpu_torch.ops import _build
    from gblastn_tpu_torch.ops import gapped as og
    from gblastn_tpu_torch.ops import gather as ogt
    from gblastn_tpu_torch.ops import replay as rp
    from gblastn_tpu_torch.ops import ungapped as ung
    from gblastn_tpu_torch.tools import (
        prof_gapped,
        prof_scan_parts,
        replay_sets,
    )

    k1 = ung.ungapped_extend_window
    k2 = og.banded_gapped_scores
    k3 = ogt.table_gather
    kg = rp.approx_gate
    kr = rp.diag_replay
    krr = rp.right_run

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    print(smi)
    card = f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
    dev = torch.device("cuda:0")
    os.environ.pop("GBLASTN_TPU_GAPPED_FILTER", None)
    os.environ.pop("GBLASTN_TPU_GAPPED_FILTER_MIN", None)

    # 2. build
    t0 = time.time()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _build.load()
    print(f"build: {time.time() - t0:.1f} s")
    ptxas = ptxas_kernels(_build.build_log)
    for src, fn, regs, st, ld in ptxas:
        print(f"ptxas: {src} {fn}: {regs} registers, spill stores {st} / "
              f"loads {ld} bytes")
    regs = {}
    for source, what in ((K1_SOURCE, "K1"), (G_SOURCE, "G"),
                         (R_SOURCE, "R"), (RR_SOURCE, "RR")):
        name = Path(source).name
        regs[what] = {fn: r for src, fn, r, _st, _ld in ptxas
                      if src == name}
        # R has a one-hit and a two-hit kernel, each with a wide twin
        # (int64 coordinates); RR a narrow and a wide one
        check(len(regs[what]) == {"R": 4, "RR": 2}.get(what, 1),
              f"ptxas reported {what}'s kernels as {regs[what]}")
        check(all(st == ld == 0 for src, _fn, _r, st, ld in ptxas
                  if src == name), f"{what} spills registers")

    # config-1 workload (bench.py's recipe and seed)
    rng = np.random.default_rng(SEED)
    genome = make_genome(rng, GENOME_LEN)
    pairs, starts = sample_reads(rng, genome, NUM_QUERIES, QUERY_LEN, "w0_")
    reads = [FastaRecord(n, "", s) for n, s in pairs]
    options = megablast_options(evalue=1e-5, max_target_seqs=10)
    db = SequenceDB.from_records(
        [FastaRecord("ecoli_synth", "synthetic E. coli scale genome",
                     genome)], title="ecoli_synth",
    )

    # 3. K1 against its plain version on the card
    batch = setup_batch(reads, db, options, dev)
    ctx1, k1_args, _n = ungapped_inputs(batch.seed_dev, **batch.seed_kw)
    k1_c1 = compare_k1(k1_args, "config-1 batch seeds", card, 50)
    k1_rand = compare_k1(random_k1_args(dev),
                         "random seeds, N/R/Y, 12 subjects", card, 20)
    # 3b. G and R at config 1's search-path inputs, and run_seeding
    # against the host finish
    g_c1, r_c1 = compare_finish(batch, "config-1 batch", card, 50, k1_c1)
    check_finish_guards(batch, "config-1 batch", card)
    del batch, k1_args, ctx1

    # 4. K2 against its plain version on the card: random jobs of both
    # scorings
    k2_rand = [compare_k2(args, kw, label, card, 20)
               for label, args, kw in random_k2_cases(dev)]

    # 4a. G and R against their plain versions on their random sets: the
    # long repeat, ambiguity codes and subject ends; a dense chain,
    # identical seeds and the aliasing mask
    g_args, g_kw = replay_sets.random_gate_case(dev)
    g_rand = compare_gate(g_args, g_kw, "random seeds, a long repeat, "
                          "N/R/Y, subject ends", card, 20)
    check(g_rand["demoted"] > 0, "G's random set demoted no seed")
    r_rand = [compare_replay(a, kw, label, card, 20)
              for label, a, kw in replay_sets.random_replay_cases(dev)]
    del g_args

    # no fallback: a CUDA tensor must never reach a plain version on a
    # main path
    plain1 = ung.ungapped_extend_window_ref
    plain2 = og.banded_gapped_scores_ref
    plain3 = ogt.table_gather_ref
    plain_g = rp.approx_gate_ref
    plain_r = rp.diag_replay_ref
    plain_rr = rp.right_run_ref

    def guarded1(*args, **kw):
        check(not any(a.is_cuda for a in args),
              "a CUDA tensor reached the plain K1 on the main path")
        return plain1(*args, **kw)

    def guarded2(query, *args, **kw):
        check(not query.is_cuda,
              "a CUDA tensor reached the plain K2 on the main path")
        return plain2(query, *args, **kw)

    def guarded3(tab, idx):
        # the wrapper's dispatch; prof_scan_parts compares with the plain
        # version it imported, which this leaves alone
        check(not tab.is_cuda,
              "a CUDA tensor reached the plain table gather on a path")
        return plain3(tab, idx)

    def guarded_g(*args, **kw):
        check(not args[0].is_cuda,
              "a CUDA tensor reached the plain G on the main path")
        return plain_g(*args, **kw)

    def guarded_r(*args, **kw):
        check(not args[0].is_cuda,
              "a CUDA tensor reached the plain R on the main path")
        return plain_r(*args, **kw)

    def guarded_rr(*args, **kw):
        check(not args[3].is_cuda,
              "a CUDA tensor reached the plain RR on the main path")
        return plain_rr(*args, **kw)

    def guard(on):
        ung.ungapped_extend_window_ref = guarded1 if on else plain1
        og.banded_gapped_scores_ref = guarded2 if on else plain2
        ogt.table_gather_ref = guarded3 if on else plain3
        rp.approx_gate_ref = guarded_g if on else plain_g
        rp.diag_replay_ref = guarded_r if on else plain_r
        rp.right_run_ref = guarded_rr if on else plain_rr

    def counts_zero():
        for fn in (k1, k2, k3, kg, kr, krr):
            fn.launches = 0

    # 4b. the path of P1-P3: the scan profiler in full, which holds the
    # table gather bit-equal to its plain version and tab[idx] at P1-P3's
    # shapes (and 16 Mi probes) in both modes, the staged one on 128 KiB
    # and on the 2 MiB PV, sweeps the staged cluster count, checks the
    # staged mode's refusal above its capacity and times each; then K2's
    # parity check of prof_gapped (its plain version runs there by
    # design)
    guard(True)
    counts_zero()
    t0 = time.time()
    psp = prof_scan_parts.profile(["--device", "cuda"])
    psp_launches = (k1.launches, k2.launches, k3.launches)
    check(psp["ok"], "prof_scan_parts found a table_gather result not "
                     "bit-equal, or the staged mode took a table above its "
                     "capacity")
    guard(False)
    check(psp_launches[2] > 0,
          "table_gather was not launched on the prof_scan_parts path")
    t_psp = time.time() - t0
    counts_zero()
    t0 = time.time()
    check(prof_gapped.main(["--parity", "--device", "cuda"]) == 0,
          "prof_gapped --parity: K2 differs from its plain version")
    pg_launches = (k1.launches, k2.launches, k3.launches)
    check(pg_launches[1] == 1, "prof_gapped --parity did not launch K2")
    print(f"profilers: prof_scan_parts {t_psp:.1f} s, launches K1 "
          f"{psp_launches[0]} K2 {psp_launches[1]} table_gather "
          f"{psp_launches[2]}; prof_gapped --parity {time.time() - t0:.1f} "
          f"s, launches K2 {pg_launches[1]}  [{card}]")

    # 5. config 1 end to end through the CLI (megablast: K1; fewer than
    # 2000 gapped candidates, so K2 stays off)
    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    (work / "genome.fa").write_text(
        ">ecoli_synth synthetic E. coli scale genome\n" + genome + "\n")
    check(cli_main(["makedb", "-in", str(work / "genome.fa"), "-out",
                    str(work / "db"), "-title", "ecoli_synth"]) == 0,
          "makedb failed")

    def run_cli(args, device, out):
        t = time.time()
        rc = cli_main(args + ["-device", device, "-out", str(out)])
        torch.cuda.synchronize()
        check(rc == 0, f"blastn -device {device} exited {rc}")
        return time.time() - t

    # a read set through the CLI (against the database ``db_name`` of
    # the work directory): -device cuda twice (cold, then warm with
    # its stage report), the two outputs equal; -device cpu on the first
    # CLI batch, bytes equal to the cuda lines of its reads, then on all
    # of them when the whole cpu run would take under about two minutes;
    # each kernel's launches read around the cold cuda run; the reads
    # that miss their locus (``loci``) listed. Returns what it measured.
    def cli_path(tag, rs, loci, qlen, extra, db_name="db",
                 host_replay=False, cpu_budget=120):
        fa = work / f"{tag}.fa"
        fa.write_text("".join(f">{r.seq_id}\n{r.sequence}\n" for r in rs))
        args = ["blastn", *extra, "-query", str(fa), "-db",
                str(work / db_name), "-outfmt", "6", "-max_target_seqs", "10"]
        guard(True)
        counts_zero()
        slog.reset()
        t_cold = run_cli(args, "cuda", work / f"{tag}_cuda.tsv")
        launches = (k1.launches, k2.launches, kg.launches, kr.launches,
                    krr.launches)
        rejects = slog.diagnostics.device_gapped_rejects
        slog.reset()
        t_warm = run_cli(args, "cuda", work / f"{tag}_cuda_warm.tsv")
        spans = dict(slog.totals)
        for ln in slog.report().splitlines()[1:]:
            print(f"stage ({tag} cuda warm): {ln}")
        guard(False)
        out = (work / f"{tag}_cuda.tsv").read_bytes()
        check(out == (work / f"{tag}_cuda_warm.tsv").read_bytes(),
              f"two {tag} cuda runs disagree")
        if host_replay:
            check("host.diag_filter" in spans,
                  f"the host replay did not run on the {tag} CLI path")
        else:
            check(not any(k.startswith(("host.approx_gate",
                                        "host.diag_filter"))
                          for k in spans),
                  f"the host gate or replay ran on the {tag} CLI path")
        task = extra[extra.index("-task") + 1]
        size = (BATCH_SIZE_MEGABLAST if task == "megablast"
                else BATCH_SIZE_BLASTN)
        batches = list(batch_records(iter(rs), size))
        names = {r.seq_id for r in batches[0]}
        fa1 = work / f"{tag}_b1.fa"
        fa1.write_text("".join(f">{r.seq_id}\n{r.sequence}\n"
                               for r in batches[0]))
        args1 = list(args)
        args1[args.index("-query") + 1] = str(fa1)
        t_cpu = run_cli(args1, "cpu", work / f"{tag}_cpu_b1.tsv")
        want = b"".join(ln for ln in out.splitlines(keepends=True)
                        if ln.split(b"\t", 1)[0].decode() in names)
        check(want == (work / f"{tag}_cpu_b1.tsv").read_bytes(),
              f"{tag} tabular bytes of the first batch differ between "
              "-device cuda and cpu")
        if len(batches) == 1:
            cpu_note = f"cpu plain {t_cpu:.2f} s, bytes equal"
        elif t_cpu * len(batches) < cpu_budget:
            t_cpu = run_cli(args, "cpu", work / f"{tag}_cpu.tsv")
            check(out == (work / f"{tag}_cpu.tsv").read_bytes(),
                  f"{tag} tabular bytes differ between -device cuda and "
                  "cpu")
            cpu_note = f"cpu plain {t_cpu:.2f} s, bytes equal"
        else:
            cpu_note = (f"cpu plain {t_cpu:.2f} s for the first CLI batch "
                        f"({len(batches[0])} reads), whose bytes are equal;"
                        f" the whole cpu run (about "
                        f"{t_cpu * len(batches):.0f} s) was not made")
        missed = tabular_loci_found(out.decode(), loci, qlen) if loci else None
        seeding = spans.get("device.seeding", 0.0) * 1e3
        print(f"{tag} cli: {len(rs)} queries in {len(batches)} batches, "
              f"{out.count(b'\n')} tabular lines, launches K1 "
              f"{launches[0]} K2 {launches[1]} G {launches[2]} R "
              f"{launches[3]} RR {launches[4]}, {rejects} rejects; cuda cold "
              f"{t_cold:.2f} s, warm {t_warm:.2f} s = "
              f"{len(rs) / t_warm:.1f} q/s (device.seeding {seeding:.1f} ms "
              f"in all); {cpu_note}"
              + (f"; {len(missed)} reads missed their locus" if loci else "")
              + f"  [{card}]")
        return {"launches": launches, "batches": len(batches),
                "missed": missed}

    c1 = cli_path("config1", reads,
                  {r.seq_id: s for r, s in zip(reads, starts)}, QUERY_LEN,
                  ["-task", "megablast", "-evalue", "1e-5"])
    c1_launches = c1["launches"]
    check(c1_launches[0] > 0, "K1 was not launched on the config-1 path")
    check(c1_launches[2] > 0 and c1_launches[3] > 0,
          f"G / R were launched {c1_launches[2:4]} times on config 1's path")
    check(c1_launches[4] == 0, "RR was launched on the one-hit config 1")
    check(not c1["missed"],
          f"reads missing their source locus: {c1['missed'][:5]}")

    # 6. config 2: blastn word 11 on 200 x 1.5 kb reads, same genome
    rng2 = np.random.default_rng(SEED + 2)
    pairs2, starts2 = sample_reads(rng2, genome, C2_QUERIES, C2_QUERY_LEN,
                                   "b")
    reads2 = [FastaRecord(n, "", s) for n, s in pairs2]
    b_opts = blastn_options(evalue=1e-5, max_target_seqs=10)
    batch2 = setup_batch(reads2, db, b_opts, dev)
    check(batch2.seed_kw["word_size"] == 11, "config 2 is not word 11")
    kw2 = batch2.seed_kw
    ctx2, k1_args2, n_raw2 = ungapped_inputs(batch2.seed_dev, **kw2)
    print(f"config2 seeding: lut word {kw2['lut_word']}, scan step "
          f"{kw2['scan_step']}, {n_raw2} raw seeds, "
          f"{k1_args2[3].numel()} K1 seeds")
    k1_c2 = compare_k1(k1_args2, "config-2 batch seeds", card, 20)
    del k1_args2, ctx2
    g_c2, r_c2 = compare_finish(batch2, "config-2 batch", card, 20, k1_c2)
    init2 = run_seeding(batch2.seed_dev, **batch2.seed_kw)
    dgd = _build_gapped_filter(batch2)
    check(dgd is not None, "the gapped filter is off for config 2")
    jobs2 = gapped_filter_jobs(init2, batch2.qblock, db.starts, db.lengths,
                               batch2.params, dgd)
    print(f"config2 candidates: {len(init2)}, {len(jobs2)} K2 jobs at "
          f"rows {dgd.rows}")
    check(len(init2) >= 2000, "config 2 has fewer than 2000 candidates")
    k2_c2 = compare_k2((dgd.query, dgd.subject2, dgd.matrix16, jobs2),
                       dict(rows=dgd.rows, gap_open=dgd.gap_open,
                            gap_extend=dgd.gap_extend),
                       "config-2 candidates", card, 20)
    del batch2, jobs2, dgd

    # 6a. config 2 through search(), with the filter (auto) and without
    def run_search(mode):
        os.environ["GBLASTN_TPU_GAPPED_FILTER"] = mode
        counts_zero()
        slog.reset()
        t = time.time()
        res = search(reads2, db, b_opts, device=dev)
        torch.cuda.synchronize()
        t = time.time() - t
        os.environ.pop("GBLASTN_TPU_GAPPED_FILTER")
        return (res, t, (k1.launches, k2.launches, kg.launches,
                         kr.launches, krr.launches), dict(slog.totals),
                slog.diagnostics.device_gapped_rejects,
                slog.diagnostics.gapped_extensions, dict(slog.values))

    guard(True)
    on = run_search("auto")
    off = run_search("0")
    guard(False)
    res_on, t_on, s_launch, spans_on, rejects, ext_on, vals_on = on
    res_off, t_off, off_launch, spans_off, _r, ext_off, _v = off
    check(min(s_launch[:4]) >= 1 and s_launch[4] == 0,
          f"config-2 search launches K1/K2/G/R/RR {s_launch}")
    check(not any(k.startswith("host.approx_gate")
                  or k.startswith("host.diag_filter") for k in spans_on),
          "the host gate or replay ran on the config-2 search path")
    check(off_launch[1] == 0, "K2 ran with the filter off")
    check(rejects > 0, "the gapped filter rejected no candidate")
    check(hsp_rows(res_on) == hsp_rows(res_off),
          "config-2 results differ with and without the gapped filter")
    found = 0
    for q in res_on.queries:
        st = starts2[q.query_index]
        if any(h.s_off < st + C2_QUERY_LEN and h.s_end > st
               for lst in q.hsplists for h in lst.hsps):
            found += 1
    check(found == C2_QUERIES,
          f"config 2: {C2_QUERIES - found} reads missed their locus")
    print(f"config2 search: launches K1 {s_launch[0]} K2 {s_launch[1]} G "
          f"{s_launch[2]} R {s_launch[3]}, {int(vals_on['seeding.gate_need'])}"
          f" seeds gated, {int(vals_on['seeding.fetch_bytes'])} bytes "
          f"fetched by the device finish; "
          f"{rejects} of {ext_on} candidates rejected on the device "
          f"({ext_off} host extensions without the filter); search "
          f"{t_on:.2f} s vs {t_off:.2f} s; host.prelim_gapped "
          f"{spans_on['host.prelim_gapped'] * 1e3:.1f} ms (of which "
          f"device.gapped_filter "
          f"{spans_on['device.gapped_filter'] * 1e3:.1f} ms) vs "
          f"{spans_off['host.prelim_gapped'] * 1e3:.1f} ms; results "
          f"identical, all {C2_QUERIES} loci found  [{card}]")
    for name in sorted(spans_on):
        print(f"stage (config2 search, filter on / off): {name} "
              f"{spans_on[name] * 1e3:.1f} / "
              f"{spans_off.get(name, 0.0) * 1e3:.1f} ms")
    del res_on, res_off

    # 6b. config 2 through the CLI: K2 runs on every batch
    c2 = cli_path("config2", reads2,
                  {r.seq_id: s for r, s in zip(reads2, starts2)},
                  C2_QUERY_LEN, ["-task", "blastn", "-evalue", "1e-5"])
    c2_launches, n_batches = c2["launches"], c2["batches"]
    check(c2_launches[0] >= 1, "K1 was not launched on the config-2 CLI")
    check(c2_launches[1] == n_batches,
          f"K2 ran {c2_launches[1]} times over {n_batches} CLI batches")
    check(c2_launches[2] == c2_launches[3] == n_batches,
          f"G / R ran {c2_launches[2:4]} times over {n_batches} CLI batches")
    check(c2_launches[4] == 0, "RR was launched on the one-hit config 2")
    check(not c2["missed"],
          f"config-2 reads missing their locus: {c2['missed'][:5]}")

    # 6c. two-hit seeding and discontiguous megablast: configs 1w
    # (megablast -window_size 40: word 28 over LUT width 12, so RR
    # probes), 2w (blastn -window_size 40: LUT width 11, the rr_zero
    # rule) and 2d (dc-megablast, template 18 coding, window 40: rr_zero
    # too); at each, RR (1w), G and the two-hit R against their plain
    # versions and run_seeding against the host oracle with the window;
    # K1 on 2d's discontiguous seeds; RR and the two-hit R on their
    # random sets
    from gblastn_tpu_torch.engine.seeding import probes_double_words
    from gblastn_tpu_torch.tools.prof_e2e import config_options
    from gblastn_tpu_torch.tools.replay_sets import batch_run_case

    pairs2d, starts2d = config2d_reads(genome)
    reads2d = [FastaRecord(n, "", s) for n, s in pairs2d]
    two_hit = {"config1w": (reads, starts, QUERY_LEN),
               "config2w": (reads2, starts2, C2_QUERY_LEN),
               "config2d": (reads2d, starts2d, C2_QUERY_LEN)}
    rr_recs, g2_recs, r2_recs = {}, {}, {}
    for name, (rs, _st, _ql) in two_hit.items():
        b = setup_batch(rs, db, config_options(name), dev)
        kw_b = b.seed_kw
        probes = probes_double_words(b.seed_dev, kw_b)
        check(probes == (name == "config1w"),
              f"{name}: RR {'runs' if probes else 'does not run'}")
        print(f"{name} seeding: word {kw_b['word_size']}, lut word "
              f"{kw_b['lut_word']}, scan step {kw_b['scan_step']}, window "
              f"{b.seed_dev.window}, template "
              f"{kw_b['disc_offsets'] or 'contiguous'}; RR "
              f"{'runs' if probes else 'does not run (rr_zero)'}")
        if name == "config2d":
            k1_2d = compare_k1(ungapped_inputs(b.seed_dev, **kw_b)[1],
                               "config-2d discontiguous seeds", card, 20)
        if probes:
            rr_recs[name] = compare_run(*batch_run_case(b), f"{name} batch",
                                        card, 20)
        g2_recs[name], r2_recs[name] = compare_finish(b, f"{name} batch",
                                                      card, 20)
        check_finish_guards(b, f"{name} batch", card)
        del b
    rr_rand = [compare_run(a, kw, label, card, 20)
               for label, a, kw in replay_sets.random_run_cases(dev)]
    r2_rand = [compare_replay(a, kw, label, card, 20)
               for label, a, kw in replay_sets.random_two_hit_cases(dev)]
    check(min(r["double_words"] for r in rr_rand) > 0,
          "RR's random sets hold no double word")

    # 6d. config 2d through search(), twice (its first call builds the
    # batch's tables on a warm card)
    d_opts = config_options("config2d")
    d_runs = []
    guard(True)
    for _ in range(2):
        counts_zero()
        slog.reset()
        t = time.time()
        res = search(reads2d, db, d_opts, device=dev)
        torch.cuda.synchronize()
        d_runs.append((time.time() - t, (k1.launches, k2.launches,
                                         kg.launches, kr.launches,
                                         krr.launches), dict(slog.totals)))
    guard(False)
    d_launch, d_spans = d_runs[-1][1], d_runs[-1][2]
    check(min(d_launch[0], d_launch[2], d_launch[3]) >= 1
          and d_launch[4] == 0,
          f"config-2d search launches K1/K2/G/R/RR {d_launch}")
    check(not any(k.startswith(("host.approx_gate", "host.diag_filter"))
                  for k in d_spans),
          "the host gate or replay ran on the config-2d search path")
    d_found = sum(
        any(h.s_off < starts2d[q.query_index] + C2_QUERY_LEN
            and h.s_end > starts2d[q.query_index]
            for lst in q.hsplists for h in lst.hsps) for q in res.queries)
    # dc-megablast on reads with a third of their third codon positions
    # changed may lose a read (no two template hits within the window):
    # counted and printed, not a failure
    print(f"config2d search: {C2_QUERIES} reads, {d_found} found their "
          f"locus ({C2_QUERIES - d_found} missed), launches K1 "
          f"{d_launch[0]} K2 {d_launch[1]} G {d_launch[2]} R {d_launch[3]} "
          f"RR {d_launch[4]}; search {d_runs[0][0]:.3f} s then "
          f"{d_runs[1][0]:.3f} s; device.seeding "
          f"{d_spans['device.seeding'] * 1e3:.2f} ms (finish "
          f"{d_spans['device.seeding.finish'] * 1e3:.2f}, fetch "
          f"{d_spans['device.seeding.fetch'] * 1e3:.2f})  [{card}]")
    for key in sorted(d_spans):
        print(f"stage (config2d search): {key} {d_spans[key] * 1e3:.1f} ms")
    del res

    # 6e. configs 1w, 2w and 2d, a blastn-short batch and a vecscreen
    # batch through the CLI (cli_path)
    cli_paths = {}
    for tag, extra in (("config1w", ["-task", "megablast", "-evalue",
                                     "1e-5", "-window_size", "40"]),
                       ("config2w", ["-task", "blastn", "-evalue", "1e-5",
                                     "-window_size", "40"]),
                       ("config2d", ["-task", "dc-megablast", "-evalue",
                                     "1e-5"])):
        rs, st, ql = two_hit[tag]
        cli_paths[tag] = cli_path(
            tag, rs, {r.seq_id: x for r, x in zip(rs, st)}, ql, extra)
    # blastn-short: 60 reads of 40 bases (one substitution in half of
    # them, every third reverse-complemented); vecscreen: 30 reads of
    # 400 bases with 2% substitutions
    rng5 = np.random.default_rng(SEED + 7)
    comp = str.maketrans("ACGT", "TGCA")
    short, vec = [], []
    for i in range(60):
        st = int(rng5.integers(0, len(genome) - 40))
        r = list(genome[st: st + 40])
        if i % 2:
            p = int(rng5.integers(0, 40))
            r[p] = "ACGT"[("ACGT".index(r[p]) + 1) % 4]
        seq = "".join(r)
        short.append(FastaRecord(f"s{i}", "", seq.translate(comp)[::-1]
                                 if i % 3 == 0 else seq))
    vec_pairs, vec_starts = sample_reads(rng5, genome, 30, 400, "v")
    vec = [FastaRecord(n, "", x) for n, x in vec_pairs]
    cli_paths["blastn_short"] = cli_path("blastn_short", short, None, 40,
                                         ["-task", "blastn-short"])
    cli_paths["vecscreen"] = cli_path(
        "vecscreen", vec, {r.seq_id: x for r, x in zip(vec, vec_starts)},
        400, ["-task", "vecscreen"])
    for tag, c in cli_paths.items():
        ln, nb = c["launches"], c["batches"]
        rr_ok = (ln[4] == nb) if tag == "config1w" else ln[4] == 0
        check(ln[0] >= nb and ln[3] == nb and rr_ok,
              f"{tag} CLI launches K1/K2/G/R/RR {ln} over {nb} batches")
        check(ln[2] == (0 if tag == "blastn_short" else nb),
              f"{tag} CLI launched G {ln[2]} times over {nb} batches")
    # 6e'. two-hit seeding with -off_diagonal_range 4 (ROADMAP item 10's
    # rest) at configs 1w, 2w and 2d through the CLI (cli_path): the card
    # runs the scan, K1, RR (1w) and G, the host the replay across
    # diagonals (no sort, no R); cuda bytes equal cpu bytes; run_seeding
    # at 2w equal to the host finish with the scan range, field by field,
    # and the host replay timed; the below-cutoff admission set of
    # tests/test_oracle_parity.py through search() on the card
    import dataclasses

    from gblastn_tpu_torch.engine.seeding import _finish_init_hits
    from gblastn_tpu_torch.tools.workloads import below_cutoff_reads

    t_r4 = time.time()
    for tag, extra in (("config1w", ["-task", "megablast", "-evalue",
                                     "1e-5", "-window_size", "40"]),
                       ("config2w", ["-task", "blastn", "-evalue", "1e-5",
                                     "-window_size", "40"]),
                       ("config2d", ["-task", "dc-megablast", "-evalue",
                                     "1e-5"])):
        rs, st, ql = two_hit[tag]
        c = cli_path(f"{tag}_r4", rs, {r.seq_id: x for r, x in zip(rs, st)},
                     ql, extra + ["-off_diagonal_range", "4"],
                     host_replay=True, cpu_budget=60)
        ln, nb = c["launches"], c["batches"]
        check(ln[0] >= nb and ln[2] == nb and ln[3] == 0
              and ln[4] == (nb if tag == "config1w" else 0),
              f"{tag} -off_diagonal_range 4 CLI launches K1/K2/G/R/RR {ln} "
              f"over {nb} batches")
        cli_paths[f"{tag}_r4"] = c
    b = setup_batch(reads2, db, dataclasses.replace(
        config_options("config2w"), off_diagonal_range=4), dev)
    kw_b, okw = b.seed_kw, b.oracle_kw
    check(kw_b["scan_range"] == 4, "config 2w's batch lost the scan range")
    guard(True)
    counts_zero()
    slog.reset()
    t0 = time.time()
    got = run_seeding(b.seed_dev, **kw_b)
    t_dev = time.time() - t0
    guard(False)
    r4_launch = (k1.launches, k2.launches, kg.launches, kr.launches,
                 krr.launches)
    t_replay = slog.totals["host.diag_filter"]
    t_approx2 = slog.totals.get("host.approx_gate", 0.0)
    fetched = int(slog.values["seeding.fetch_bytes"])
    check(r4_launch == (1, 0, 1, 0, 0),
          f"2w run_seeding at range 4 launched K1/K2/G/R/RR {r4_launch}")
    ctx, k1_args, _n = ungapped_inputs(b.seed_dev, **kw_b)
    ext = k1(*k1_args)
    n_k1 = k1_args[3].numel()
    rows = [t.cpu().numpy() for t in (k1_args[3], k1_args[4], ctx,
                                      *ext[:4])]
    n_ctx = len(kw_b["x_dropoffs"])
    t0 = time.time()
    want = _finish_init_hits(
        *rows, okw["word_cutoffs"], okw["subject_starts"],
        kw_b["word_size"],
        concat_qlen=int(kw_b["context_offsets"][n_ctx]) - 2,
        approx_ctx=okw["approx_ctx"], window_size=40,
        right_run=np.zeros(n_k1, np.int32), scan_range=4)
    t_host = time.time() - t0
    for name in ("q_off", "s_off", "q_start", "s_start", "length", "score",
                 "context", "oid"):
        check(np.array_equal(getattr(got, name), getattr(want, name)),
              f"2w at range 4: run_seeding's {name} differs from the host "
              "finish")
    r0 = run_seeding(setup_batch(reads2, db, config_options("config2w"),
                                 dev).seed_dev, **kw_b | {"scan_range": 0})
    del b, k1_args, ext, rows, ctx
    # the below-cutoff admission set: 0 HSPs at range 0, at least 8 at 4
    g_bc, bc_reads = below_cutoff_reads()
    bc_db = SequenceDB.from_records([FastaRecord("chr1", "", g_bc)])
    bc_recs = [FastaRecord(*r) for r in bc_reads]
    bc_n = {}
    for sr in (0, 4):
        guard(True)
        counts_zero()
        try:
            res = search(bc_recs, bc_db, blastn_options(
                evalue=20.0, window_size=40, dust=False,
                off_diagonal_range=sr), device=dev)
        finally:
            guard(False)
        bc_n[sr] = (sum(len(l.hsps) for q in res.queries
                        for l in q.hsplists),
                    (k1.launches, kg.launches, kr.launches))
    check(bc_n[0][0] == 0 and bc_n[4][0] >= 8,
          f"the below-cutoff set gave {bc_n[0][0]} HSPs at range 0 and "
          f"{bc_n[4][0]} at range 4")
    check(bc_n[4][1][2] == 0 and bc_n[0][1][2] == 1,
          f"the below-cutoff set launched K1/G/R {bc_n}")
    print(f"off-diagonal range 4: 2w run_seeding {len(got)} saved of {n_k1} "
          f"K1 seeds (range 0: {len(r0)}), equal field by field to the host "
          f"finish; run_seeding {t_dev * 1e3:.1f} ms with the host replay "
          f"{t_replay * 1e3:.1f} ms and the second approximate pass "
          f"{t_approx2 * 1e3:.1f} ms, {fetched} bytes fetched; the host "
          f"finish on K1's rows {t_host:.2f} s; launches K1 {r4_launch[0]} "
          f"K2 {r4_launch[1]} G {r4_launch[2]} R {r4_launch[3]} RR "
          f"{r4_launch[4]}; below-cutoff set {bc_n[0][0]} HSPs at range 0, "
          f"{bc_n[4][0]} at range 4 (search() on the card, K1/G/R "
          f"{bc_n[4][1]}); phase {time.time() - t_r4:.1f} s  [{card}]")
    del got, want, r0, bc_db

    # one CLI run on the card with the plain versions guarded and every
    # launch counter and stage timer set to 0 just before it: (output
    # bytes, launches of K1, K2, G, R and RR, seconds, stage totals)
    def card_run(args, out):
        guard(True)
        counts_zero()
        slog.reset()
        try:
            t = run_cli(args, "cuda", out)
        finally:
            guard(False)
        return (Path(out).read_bytes(), (k1.launches, k2.launches,
                                         kg.launches, kr.launches,
                                         krr.launches), t, dict(slog.totals))

    new_paths = {"config2w_r4_run_seeding": r4_launch}

    # a CLI run with the database streamed (card_run with ``env`` set
    # around it): the bytes, launches, seconds and spans, after checking
    # that the batch streamed and never uploaded the resident form
    def stream_run(args, out, env):
        os.environ.update(env)
        try:
            got = card_run(args, out)
        finally:
            for k in env:
                os.environ.pop(k)
        check("device.seeding.stream" in got[3]
              and "setup.subject_upload" not in got[3],
              f"{out}: the batch did not stream, or uploaded the resident "
              "form")
        return got

    # each read's best hit within 64 bases of its plant (database
    # coordinates) on its subject ``owner``; returns the reads past 2^31
    # (at least 20 on giant, 30 on chroms)
    def plants_found(tag, res, g_db, pairs, plants, owner):
        starts = np.asarray(g_db.starts)
        found = bad = far = 0
        for q in res.queries:
            best = None
            for lst in q.hsplists:
                for h in lst.hsps:
                    if best is None or h.score > best[1].score:
                        best = (lst.oid, h)
            if best is None:
                continue
            found += 1
            oid, h = best
            lo = int(starts[oid]) + min(h.s_off, h.s_end)
            p = plants[q.query_index]
            if not (p - 64 <= lo <= p + 64) or oid != owner[q.query_index]:
                bad += 1
            if p + QUERY_LEN > (1 << 31):
                far += 1
        check(found == len(pairs) and bad == 0,
              f"{tag}: {found} of {len(pairs)} reads found, {bad} away from "
              "their plants")
        n_far = (far if tag.startswith("giant")
                 else sum(o >= 13 for o in owner))
        check(n_far >= (30 if tag.startswith("chroms") else 20),
              f"{tag}: {n_far} hits past 2^31")
        return n_far

    # a genome-scale phase (7a): ``pairs`` (name, sequence) planted at
    # ``plants`` (database coordinates) on subjects ``owner`` of ``g_db``,
    # through search() on the card with every launch counter set to 0 just
    # before it; each read's best hit within 64 bases of its plant, on its
    # subject; run_seeding's InitHits equal to the host finish; the
    # -outfmt 6 rendering's sstart at each plant past 2^31; the resident
    # bytes, the peak device memory, the process's peak RSS, the batch's
    # time and its largest spans printed. Returns the search's launches,
    # run_seeding's InitHits and the reads past 2^31.
    def genome_phase(tag, g_db, pairs, plants, owner, t_db):
        import io
        import resource

        from gblastn_tpu_torch.engine.resident import (
            BYTES_PER_BASE,
            SEARCH_WORK_BYTES,
            free_bytes,
        )
        from gblastn_tpu_torch.format.render import ResultRenderer
        from gblastn_tpu_torch.ops.seeding import BUILD_CHUNK

        g_reads = [FastaRecord(n, "", x) for n, x in pairs]
        free0 = free_bytes(dev)
        total = torch.cuda.mem_get_info(dev)[1]
        torch.cuda.reset_peak_memory_stats()
        guard(True)
        counts_zero()
        slog.reset()
        t0 = time.time()
        try:
            res = search(g_reads, g_db, options, device=dev)
            torch.cuda.synchronize()
        finally:
            guard(False)
        t_cold = time.time() - t0
        launch = (k1.launches, k2.launches, kg.launches, kr.launches,
                  krr.launches)
        spans = dict(slog.totals)
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        check(launch[0] == launch[2] == launch[3] == 1 and launch[4] == 0,
              f"{tag}: search() launches K1/K2/G/R/RR {launch}")
        n_far = plants_found(tag, res, g_db, pairs, plants, owner)
        starts = np.asarray(g_db.starts)
        # the -outfmt 6 rendering: each read past 2^31 prints its plant
        buf = io.StringIO()
        rr = ResultRenderer(6, None, buf, g_db, options, dbname=tag,
                            task="megablast")
        rr.emit(res)
        rr.finalize()
        first = {}
        for line in buf.getvalue().splitlines():
            f = line.split("\t")
            first.setdefault(f[0], f)
        shown = 0
        for i, (name, _x) in enumerate(pairs):
            if plants[i] + QUERY_LEN <= (1 << 31):
                continue
            f = first[name]
            k = owner[i]
            local = plants[i] - int(starts[k])
            lo = min(int(f[8]), int(f[9])) - 1
            check(f[1] == g_db.ids[k] and abs(lo - local) <= 64,
                  f"{tag}: {name} printed {f[1]} {f[8]}-{f[9]}, planted at "
                  f"{g_db.ids[k]} {local}")
            shown += 1
        # run_seeding against the host finish on the full fetch of K1's
        # rows
        batch = setup_batch(g_reads, g_db, options, dev)
        t0 = time.time()
        got = run_seeding(batch.seed_dev, **batch.seed_kw)
        t_dev = time.time() - t0
        want, t_host, n_k1, n_raw = host_init(batch)
        same_init(got, want, f"{tag}: run_seeding against the host finish")
        check(int(np.max(got.s_start)) > (1 << 31),
              f"{tag}: no saved seed past 2^31")
        r = next(iter(g_db._torch_resident.values()))
        held = nbytes(r.packed, r.subject2, r.valid, r.subject_w, r.starts,
                      r.ends)
        from gblastn_tpu_torch.engine.seeding import NARROW_SUBJECT

        layout = rp.key_layout(g_db.num_seqs, r.longest,
                               batch.seed_dev.query_packed.numel(), 0)
        key_note = (f"R's key one sort of {layout} bits" if layout else
                    "R's key two sorts (the packed key passes 63 bits)")
        key_note += (", R's wide kernels (int64 coordinates)"
                     if r.longest >= NARROW_SUBJECT else
                     ", R's narrow kernels")
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        check(peak_reserved - held <= SEARCH_WORK_BYTES,
              f"{tag}: the search took {peak_reserved - held} bytes beside "
              f"the resident form, past the check's {SEARCH_WORK_BYTES}")
        # resident_bytes' chunk and subject terms, SEARCH_WORK_BYTES
        largest = int((free0 - SEARCH_WORK_BYTES - 16 * BUILD_CHUNK - 16)
                      / BYTES_PER_BASE)
        top = sorted(spans.items(), key=lambda kv: -kv[1])[:6]
        print(f"{tag}: {g_db.num_seqs} subjects, {g_db.total_length} bases "
              f"({g_db.padded_length} padded; host build {t_db:.1f} s); "
              f"{len(pairs)} reads all found at their plants, 0 mismatches, "
              f"{n_far} hits past 2^31, {shown} printed at their plants by "
              f"-outfmt 6; launches K1 {launch[0]} K2 {launch[1]} G "
              f"{launch[2]} R {launch[3]} RR {launch[4]}; search() "
              f"{t_cold:.2f} s cold (with the upload) ("
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in top)
              + f"); resident {held} bytes = {held / g_db.padded_length:.3f}"
              f" B a base; peak device memory {peak} bytes "
              f"({peak / 2**30:.2f} GiB; the search's own {peak - held}, "
              f"{peak_reserved - held} of the allocator's peak reserve "
              f"{peak_reserved}; the check allows {SEARCH_WORK_BYTES}); "
              f"{free0} of {total} bytes of the card free before the "
              f"upload, so by the check the largest database it holds is "
              f"about {largest} bases; peak RSS {rss / 2**30:.2f} GiB; "
              f"run_seeding {t_dev * 1e3:.1f} ms warm, {n_raw} raw seeds, "
              f"{n_k1} K1 seeds, {len(got)} saved, equal "
              f"field by field to the host finish ({t_host:.2f} s); "
              f"{key_note}  [{card}]")
        del batch, res, r
        return launch, got, n_far

    # 7c. giant past the card's memory (ROADMAP item 13's rest): streamed
    # with GBLASTN_TPU_STREAM=1 first, for its device peak; then, with no
    # variable set, a ballast tensor leaves the card less free memory
    # than the resident check demands and more than that peak and the
    # streamed path's own check: search() streams on its own (the span
    # device.seeding.stream, no setup.subject_upload), every read at its
    # plant and as many past 2^31 as 7a found; the streamed InitHits equal
    # 7a's resident ones (``want``) field by field; K1's launches (at most
    # one a block), the escalated seeds, the peak device memory and the
    # time printed. Returns the search's launches.
    def giant_streamed(g_db, pairs, plants, owner, want, want_far):
        from gblastn_tpu_torch.engine.resident import (
            SEARCH_WORK_BYTES,
            free_bytes,
            resident_bytes,
        )
        from gblastn_tpu_torch.engine.stream import (
            run_seeding_streamed,
            stream_bytes,
        )

        g_reads = [FastaRecord(n, "", x) for n, x in pairs]
        g_db._torch_resident.clear()
        torch.cuda.empty_cache()
        os.environ["GBLASTN_TPU_STREAM"] = "1"
        try:
            torch.cuda.reset_peak_memory_stats()
            slog.reset()
            t0 = time.time()
            res = search(g_reads, g_db, options, device=dev)
            torch.cuda.synchronize()
            t_forced = time.time() - t0
            forced_peak = torch.cuda.max_memory_reserved()
            forced_alloc = torch.cuda.max_memory_allocated()
            plants_found("giant (GBLASTN_TPU_STREAM=1)", res, g_db, pairs,
                         plants, owner)
            sdb = setup_batch(g_reads, g_db, options, dev).stream
        finally:
            os.environ.pop("GBLASTN_TPU_STREAM")
        need_stream = stream_bytes(sdb.plan, g_db.num_seqs)
        need_res = (resident_bytes(g_db.padded_length, g_db.num_seqs)
                    + SEARCH_WORK_BYTES)
        n_blocks = sdb.plan.n_blocks
        cached = sum(c["bytes"] for c in g_db._torch_stream_cache.values())
        del res, sdb
        g_db._torch_stream_cache.clear()
        torch.cuda.empty_cache()
        # the streamed check's need against the peak reserve less the
        # block cache (which takes only what is free beside the need)
        work_peak = forced_peak - cached
        check(work_peak <= need_stream,
              f"giant: the streamed search reserved {forced_peak} bytes, "
              f"{work_peak} beside its {cached}-byte block cache, past its "
              f"check's {need_stream}")
        low = max(work_peak, need_stream)
        check(low < need_res,
              f"giant: the streamed search's peak {work_peak} or need "
              f"{need_stream} is not below the resident need {need_res}")
        target = (low + need_res) // 2
        free = free_bytes(dev)
        check(free > target, f"giant: {free} bytes free, under {target}")
        ballast = torch.empty(free - target, dtype=torch.uint8, device=dev)
        try:
            free_b = free_bytes(dev)
            check(low <= free_b < need_res,
                  f"giant: {free_b} bytes free under the ballast, not in "
                  f"[{low}, {need_res})")
            torch.cuda.reset_peak_memory_stats()
            guard(True)
            counts_zero()
            slog.reset()
            t0 = time.time()
            try:
                res = search(g_reads, g_db, options, device=dev)
                torch.cuda.synchronize()
            finally:
                guard(False)
            t_auto = time.time() - t0
            launch = (k1.launches, k2.launches, kg.launches, kr.launches,
                      krr.launches)
            spans, vals = dict(slog.totals), dict(slog.values)
            held = ballast.numel()
            peak = torch.cuda.max_memory_allocated() - held
            peak_res = torch.cuda.max_memory_reserved() - held
            check("device.seeding.stream" in spans
                  and "setup.subject_upload" not in spans,
                  "giant under the ballast did not stream on its own, or "
                  "uploaded the resident form")
            blocks = int(vals["seeding.stream_blocks"])
            check(1 <= launch[0] <= blocks
                  and launch[1:] == (0, launch[0], 1, 0),
                  f"giant streamed: launches K1/K2/G/R/RR {launch} over "
                  f"{blocks} blocks")
            n_far = plants_found("giant (streamed on its own)", res, g_db,
                                 pairs, plants, owner)
            check(n_far == want_far,
                  f"giant streamed: {n_far} hits past 2^31, resident "
                  f"{want_far}")
            batch = setup_batch(g_reads, g_db, options, dev)
            check(batch.stream is not None,
                  "giant's batch under the ballast did not stream")
            slog.reset()
            t0 = time.time()
            got = run_seeding_streamed(batch.stream, batch.seed_dev,
                                       **batch.seed_kw)
            t_seed = time.time() - t0
            escalated = int(slog.values["seeding.stream_escalated"])
            gate_edges = int(slog.values["seeding.stream_gate_edges"])
            same_init(got, want, "giant streamed against the resident "
                      "run_seeding (held to the host finish in 7a)")
            del batch, res
        finally:
            del ballast
            torch.cuda.empty_cache()
        top = sorted(spans.items(), key=lambda kv: -kv[1])[:6]
        print(f"giant streamed: GBLASTN_TPU_STREAM=1 {t_forced:.2f} s, "
              f"peak reserve {forced_peak} ({forced_alloc} allocated), "
              f"{work_peak} beside the {cached}-byte block cache "
              f"({100 * work_peak / need_stream:.1f}% of the streamed "
              f"need); the check's needs: resident {need_res}, streamed "
              f"{need_stream}; "
              f"a ballast left {free_b} bytes free and search() streamed "
              f"on its own in {n_blocks} blocks ({blocks} with scan work): "
              f"{len(pairs)} reads at their plants, {n_far} past 2^31; "
              f"launches K1 {launch[0]} K2 {launch[1]} G {launch[2]} R "
              f"{launch[3]} RR {launch[4]}; {escalated} seeds escalated on "
              f"the host ({gate_edges} for G alone); search() "
              f"{t_auto:.2f} s with cold blocks (the "
              f"host's subject caches warm from 7a) ("
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in top)
              + f"); peak device memory {peak} bytes ({peak / 2**30:.2f} "
              f"GiB; reserve {peak_res}); streamed seeding {t_seed:.2f} s, "
              f"{len(got)} InitHits equal field by field to the resident "
              f"run_seeding's  [{card}]")
        return launch

    # 6f. query splitting (ROADMAP item 10): a second strain's assembly as
    # one query longer than the chunk (segments of 20 kb from random
    # places and strands of config 1's genome, 2% substitutions), 5.5 Mb
    # with megablast (5 Mb chunks) and 1.2 Mb with blastn (1 Mb chunks)
    # through the CLI on the card: at least two chunks, every segment's
    # locus found, the segment across the first chunk boundary one merged
    # HSP. cuda bytes equal cpu bytes on the same recipe where the plain
    # path can run it (its K1 walks every seed of a segment to the
    # segment's ends): megablast at CHUNK_SIZE=1000000 on the 1.2 Mb
    # query, blastn at CHUNK_SIZE=25000 on its first 30 kb
    from gblastn_tpu_torch.engine.split import (
        chunk_size_for_task,
        overlap_size,
        split_records,
    )
    from gblastn_tpu_torch.tools.workloads import plant_repeats, strain_query

    def strain_missing(text, pieces):
        """The segments (query start, genome start, length, minus) with no
        tabular line over half of both their query span and their
        locus."""
        spans = []
        for line in text.splitlines():
            f = line.split("\t")
            s0, s1 = sorted((int(f[8]), int(f[9])))
            spans.append((int(f[6]) - 1, int(f[7]), s0 - 1, s1))
        return [p for p in pieces if not any(
            min(q1, p[0] + p[2]) - max(q0, p[0]) >= p[2] // 2
            and min(s1, p[1] + p[2]) - max(s0, p[1]) >= p[2] // 2
            for q0, q1, s0, s1 in spans)]

    def merged_across(text, chunk):
        """A tabular line 1,000 bases deep on both sides of the first
        chunk boundary (the overlap strip included)."""
        lo = chunk - overlap_size() - 1000
        return any(int(f[6]) - 1 < lo and int(f[7]) > chunk + 1000
                   for f in (ln.split("\t") for ln in text.splitlines()))

    rng6 = np.random.default_rng(SEED + 9)
    strain55, pieces55 = strain_query(rng6, genome, 5_500_000)
    strain12, pieces12 = strain_query(rng6, genome, 1_200_000)
    split_notes = []
    t_split = time.time()
    for tag, seq, pieces, task, chunk_env, on_cpu in (
            ("split_megablast", strain55, pieces55, "megablast", None,
             False),
            ("split_blastn", strain12, pieces12, "blastn", None, False),
            ("split_megablast_1m", strain12, pieces12, "megablast",
             1_000_000, True),
            ("split_blastn_30k", strain12[:30_000], pieces12[:2], "blastn",
             25_000, True)):
        if chunk_env:
            os.environ["CHUNK_SIZE"] = str(chunk_env)
        try:
            chunk = chunk_size_for_task(task)
            recs, info, _any = split_records([FastaRecord("strain", "", seq)],
                                             chunk, overlap_size())
            check(len(info) >= 2, f"{tag}: split_records made {len(info)} "
                                  f"chunk(s) of a {len(seq)}-base query")
            fa = work / f"{tag}.fa"
            fa.write_text(f">strain\n{seq}\n")
            args = ["blastn", "-task", task, "-evalue", "1e-5", "-query",
                    str(fa), "-db", str(work / "db"), "-outfmt", "6"]
            out, launch, t_cuda, spans = card_run(args,
                                                  work / f"{tag}_cuda.tsv")
            text = out.decode()
            missing = strain_missing(text, pieces)
            check(not missing, f"{tag}: {len(missing)} of {len(pieces)} "
                               f"segments missed their locus: {missing[:3]}")
            check(merged_across(text, chunk),
                  f"{tag}: no HSP crosses the chunk boundary at {chunk}")
            check(launch[0] >= 1 and launch[2] >= 1 and launch[3] >= 1,
                  f"{tag}: launches K1/K2/G/R/RR {launch}")
            note = ""
            if on_cpu:
                t_cpu = run_cli(args, "cpu", work / f"{tag}_cpu.tsv")
                check(out == (work / f"{tag}_cpu.tsv").read_bytes(),
                      f"{tag}: tabular bytes differ between -device cuda "
                      "and cpu")
                note = f"; cpu plain {t_cpu:.2f} s, bytes equal"
                if task == "megablast":
                    note += (f" (the 5.5 Mb query's cpu run, about "
                             f"{t_cpu * len(strain55) / len(seq):.0f} s at "
                             "this rate, was not made)")
            q_len = 2 * sum(len(r.sequence) + 1 for r in recs)
            layout = rp.key_layout(1, len(genome), q_len, 0)
            top = sorted(spans.items(), key=lambda kv: -kv[1])[:5]
            split_notes.append(
                f"{tag}: {len(seq)} bases, {task}, chunk {chunk}: "
                f"{len(info)} chunks, {len(pieces)} segments all found, "
                f"the boundary segment merged, {out.count(b'\n')} tabular "
                f"lines; R's key (diagonal, s, q bits) {layout}; launches "
                f"K1 {launch[0]} K2 {launch[1]} G {launch[2]} R {launch[3]}"
                f" RR {launch[4]}; cuda {t_cuda:.2f} s ("
                + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in top)
                + f"){note}")
            new_paths[f"{tag}_cli"] = launch
        finally:
            os.environ.pop("CHUNK_SIZE", None)
    for ln in split_notes:
        print(f"{ln}  [{card}]")
    print(f"split phase: {time.time() - t_split:.1f} s  [{card}]")
    del strain55, strain12

    # 6g. repeat filtering (ROADMAP item 15): a RepeatMasker-style library
    # of 1,000 elements of 300 bases, 10% of config 1's genome replaced by
    # copies of them at 10-20% divergence, 500 x 1 kb reads of that genome
    # (config 1's recipe), megablast with -filtering_db through the CLI
    # (cli_path: cuda cold and warm, cpu bytes equal); the nested search's
    # launches and masks read around each of its calls; the same run
    # without the filter on the card must differ
    import gblastn_tpu_torch.masking.repeats as mrep

    t_rep = time.time()
    rng7 = np.random.default_rng(SEED + 10)
    elems, genome_r, copies = plant_repeats(rng7, genome)
    pairs_r, starts_r = sample_reads(rng7, genome_r, NUM_QUERIES, QUERY_LEN,
                                     "r")
    reads_r = [FastaRecord(n, "", x) for n, x in pairs_r]
    (work / "rep_genome.fa").write_text(">rep_genome\n" + genome_r + "\n")
    (work / "rep_lib.fa").write_text("".join(
        f">elem{i}\n{e}\n" for i, e in enumerate(elems)))
    for src, name in (("rep_genome.fa", "rep_db"), ("rep_lib.fa", "rep_lib")):
        check(cli_main(["makedb", "-in", str(work / src), "-out",
                        str(work / name), "-title", name]) == 0,
              f"makedb {name} failed")
    del genome_r
    nested = []     # (launch deltas K1, K2, G, R, RR; masks; device)
    find = mrep.find_repeat_masks

    def counted_find(records, repeat_db, device="cuda"):
        before = (k1.launches, k2.launches, kg.launches, kr.launches,
                  krr.launches)
        masks = find(records, repeat_db, device)
        after = (k1.launches, k2.launches, kg.launches, kr.launches,
                 krr.launches)
        nested.append((tuple(a - b for a, b in zip(after, before)), masks,
                       str(device)))
        return masks

    rep_extra = ["-task", "megablast", "-evalue", "1e-5"]
    mrep.find_repeat_masks = counted_find
    try:
        rep = cli_path("repeats", reads_r,
                       {r.seq_id: x for r, x in zip(reads_r, starts_r)},
                       QUERY_LEN, rep_extra + ["-filtering_db",
                                               str(work / "rep_lib")],
                       db_name="rep_db")
    finally:
        mrep.find_repeat_masks = find
    check(not rep["missed"],
          f"repeat reads missing their locus: {rep['missed'][:5]}")
    check(len(nested) == 3 and nested[0][2].startswith("cuda")
          and nested[2][2] == "cpu",
          f"the nested repeat search ran as {[n[2] for n in nested]}")
    nest_launch, masks_r = nested[0][0], nested[0][1]
    check(min(nest_launch[0], nest_launch[2], nest_launch[3]) >= 1,
          f"the nested repeat search launched K1/K2/G/R/RR {nest_launch}")
    check(masks_r == nested[1][1] == nested[2][1],
          "the repeat masks differ between the cuda and cpu runs")
    cst = np.array([c[0] for c in copies])
    over = [int((np.minimum(st + QUERY_LEN, cst + 300)
                 - np.maximum(st, cst)).max()) for st in starts_r]
    held = [bool(m) for m, o in zip(masks_r, over) if o >= 150]
    check(sum(held) >= 0.9 * len(held),
          f"only {sum(held)} of {len(held)} reads holding 150 bases of a "
          "repeat copy were masked")
    plain_out, plain_launch, t_plain, _spans = card_run(
        ["blastn", *rep_extra, "-query", str(work / "repeats.fa"), "-db",
         str(work / "rep_db"), "-outfmt", "6", "-max_target_seqs", "10"],
        work / "repeats_plain_cuda.tsv")
    filt_out = (work / "repeats_cuda.tsv").read_bytes()
    check(plain_out != filt_out,
          "the run without -filtering_db gave the filtered run's bytes")
    print(f"repeats: {len(elems)} elements, {len(copies)} copies (10% of "
          f"the genome); {sum(map(bool, masks_r))} of {len(reads_r)} reads "
          f"masked, {sum(held)} of the {len(held)} holding 150 bases of a "
          f"copy; masks equal on cuda and cpu; nested search launches K1 "
          f"{nest_launch[0]} K2 {nest_launch[1]} G {nest_launch[2]} R "
          f"{nest_launch[3]} RR {nest_launch[4]}; {filt_out.count(b'\n')} "
          f"tabular lines filtered, {plain_out.count(b'\n')} without the "
          f"filter ({t_plain:.2f} s); phase {time.time() - t_rep:.1f} s  "
          f"[{card}]")
    new_paths["repeats_cli"] = rep["launches"]
    new_paths["repeats_nested"] = nest_launch
    new_paths["repeats_plain_cli"] = plain_launch
    del reads_r, masks_r, nested

    # 6h. pipelined mode (ROADMAP item 9), cell 1p's shape: 4 x 500
    # config-1 reads through the CLI with -mode 2 and -mode 1 (one CLI
    # batch: megablast batches hold 5 Mb), config 2's three CLI batches
    # with -mode 2 against 6b's -mode 1 bytes, and run_pipelined_search
    # called as bench.py's bench_config1_pipelined calls it, against
    # search() on the same four batches; q/s of both (a reading)
    from gblastn_tpu_torch.engine.pipeline import run_pipelined_search

    t_pipe_phase = time.time()
    rng8 = np.random.default_rng(SEED + 8)
    p_batches = [[FastaRecord(n, "", x) for n, x in sample_reads(
        rng8, genome, NUM_QUERIES, QUERY_LEN, f"p{k}_")[0]]
        for k in range(4)]
    (work / "pipeline.fa").write_text("".join(
        f">{r.seq_id}\n{r.sequence}\n" for b in p_batches for r in b))
    p_args = ["blastn", "-task", "megablast", "-evalue", "1e-5", "-query",
              str(work / "pipeline.fa"), "-db", str(work / "db"), "-outfmt",
              "6", "-max_target_seqs", "10"]
    m1 = card_run(p_args + ["-mode", "1"], work / "pipeline_m1.tsv")
    m2 = card_run(p_args + ["-mode", "2"], work / "pipeline_m2.tsv")
    check(m2[0] == m1[0], "-mode 2 and -mode 1 bytes differ (config 1p)")
    c2m2 = card_run(["blastn", "-task", "blastn", "-evalue", "1e-5",
                     "-query", str(work / "config2.fa"), "-db",
                     str(work / "db"), "-outfmt", "6", "-max_target_seqs",
                     "10", "-mode", "2"], work / "config2_m2.tsv")
    check(c2m2[0] == (work / "config2_cuda.tsv").read_bytes(),
          "config 2: -mode 2 bytes differ from -mode 1's")
    check(c2m2[1][1] == c2["batches"] and c2m2[1][3] == c2["batches"],
          f"config 2 -mode 2 launches K1/K2/G/R/RR {c2m2[1]} over "
          f"{c2['batches']} batches")
    run_pipelined_search(iter(p_batches[:1]), db, options, lambda r: None,
                         device=dev)
    # in turns: pipelined, sequential, sequential, pipelined
    times = {"pipe": [], "seq": []}
    rows = {}
    guard(True)
    for turn in ("pipe", "seq", "seq", "pipe"):
        counts_zero()
        got = []
        t = time.time()
        if turn == "pipe":
            done = run_pipelined_search(iter(p_batches), db, options,
                                        lambda r: got.extend(hsp_rows(r)),
                                        device=dev)
        else:
            for b in p_batches:
                got.extend(hsp_rows(search(b, db, options, device=dev)))
        torch.cuda.synchronize()
        times[turn].append(time.time() - t)
        rows[turn] = got
        if turn == "pipe":
            pipe_launch = (k1.launches, k2.launches, kg.launches,
                           kr.launches, krr.launches)
    guard(False)
    check(done == 4 and rows["pipe"] == rows["seq"],
          "run_pipelined_search differs from search() on the 1p batches")
    check(pipe_launch[0] == pipe_launch[2] == pipe_launch[3] == 4,
          f"run_pipelined_search launches K1/K2/G/R/RR {pipe_launch}")
    n_p = sum(len(b) for b in p_batches)

    def qps(ts):
        return " / ".join(f"{n_p / x:.1f}" for x in ts)

    print(f"pipeline (1p): CLI {n_p} reads -mode 2 {m2[2]:.2f} s = "
          f"{n_p / m2[2]:.1f} q/s, -mode 1 {m1[2]:.2f} s = "
          f"{n_p / m1[2]:.1f} q/s, bytes equal (one CLI batch); "
          f"run_pipelined_search over {done} batches {qps(times['pipe'])} "
          f"q/s (turns 1 and 4), search() {qps(times['seq'])} q/s (turns 2 "
          f"and 3), {len(rows['pipe'])} HSPs equal; config 2 -mode 2 "
          f"{c2m2[2]:.2f} s over {c2['batches']} CLI batches, bytes of "
          f"-mode 1; phase {time.time() - t_pipe_phase:.1f} s  [{card}]")
    new_paths.update({"pipeline_mode1_cli": m1[1],
                      "pipeline_mode2_cli": m2[1],
                      "config2_mode2_cli": c2m2[1],
                      "pipeline_direct": pipe_launch})
    del p_batches, rows

    # 6i. blast_formatter (ROADMAP item 16): config 1 to an -outfmt 11
    # archive on the card, then blast_formatter -outfmt 6, 7 and 10 on it
    # against direct runs in those formats (-outfmt 7's "# Database:"
    # line names the archived path where a direct run names the title,
    # as in the JAX package)
    t_fmt = time.time()
    f_args = ["blastn", "-task", "megablast", "-evalue", "1e-5", "-query",
              str(work / "config1.fa"), "-db", str(work / "db"),
              "-max_target_seqs", "10"]
    arc_launch = card_run(f_args + ["-outfmt", "11"], work / "config1.11")[1]
    for fmt in ("6", "7", "10"):
        direct = card_run(f_args + ["-outfmt", fmt],
                          work / f"config1_direct{fmt}.txt")[0]
        out = work / f"config1_formatter{fmt}.txt"
        check(cli_main(["blast_formatter", "-archive",
                        str(work / "config1.11"), "-outfmt", fmt, "-out",
                        str(out)]) == 0, f"blast_formatter -outfmt {fmt}")
        got = out.read_bytes()
        if fmt == "7":
            got, direct = ([ln for ln in x.splitlines()
                            if not ln.startswith(b"# Database:")]
                           for x in (got, direct))
        check(got == direct and len(got) > NUM_QUERIES,
              f"blast_formatter -outfmt {fmt} differs from the direct run")
    print(f"blast_formatter: config 1's archive re-rendered as -outfmt 6, "
          f"7 and 10 equals the direct runs; phase {time.time() - t_fmt:.1f}"
          f" s  [{card}]")
    new_paths["formatter_archive_cli"] = arc_launch

    # 6j. the database's masks (ROADMAP item 13): a mask column over
    # config 1's genome, intervals of 300-3,000 bases covering 30% of it
    # (about what a repeat annotation marks on a mammalian genome), built
    # by makedb -mask_data; config 1 through the CLI with -db_soft_mask and
    # with -db_hard_mask: cuda bytes equal cpu bytes, and differ from the
    # unmasked run's
    t_mask = time.time()
    rng9 = np.random.default_rng(SEED + 12)
    ivs, at = [], int(rng9.integers(0, 3000))
    while True:
        n_iv = int(rng9.integers(300, 3001))
        if at + n_iv > len(genome):
            break
        ivs.append((at, at + n_iv))
        # gaps of 7/3 an interval's mean length: 30% of the genome masked
        at += n_iv + int(rng9.integers(1, 2 * 1650 * 7 // 3))
    covered = sum(b - a for a, b in ivs) / len(genome)
    check(0.25 < covered < 0.35, f"the mask covers {covered:.1%}")
    (work / "mask.intervals").write_text(
        ">ecoli_synth\n" + "".join(f"{a} - {b - 1}\n" for a, b in ivs))
    check(cli_main(["makedb", "-in", str(work / "genome.fa"), "-out",
                    str(work / "db_mask"), "-title", "ecoli_synth",
                    "-mask_data", str(work / "mask.intervals"), "-mask_id",
                    "40"]) == 0, "makedb -mask_data failed")
    unmasked1 = (work / "config1_cuda.tsv").read_bytes()
    c1_args = ["blastn", "-task", "megablast", "-evalue", "1e-5", "-query",
               str(work / "config1.fa"), "-outfmt", "6", "-max_target_seqs",
               "10"]
    mask_out = {}
    mask_notes = []
    for flag in ("-db_soft_mask", "-db_hard_mask"):
        tag = flag.strip("-")
        args = c1_args + ["-db", str(work / "db_mask"), flag, "40"]
        out, launch, t_cuda, _spans = card_run(args, work / f"{tag}.tsv")
        t_cpu = run_cli(args, "cpu", work / f"{tag}_cpu.tsv")
        check(out == (work / f"{tag}_cpu.tsv").read_bytes(),
              f"config 1 {flag}: cuda and cpu bytes differ")
        check(out != unmasked1, f"config 1 {flag}: the bytes of the unmasked "
                             "run")
        check(launch[0] == launch[2] == launch[3] == 1,
              f"config 1 {flag}: launches K1/K2/G/R/RR {launch}")
        mask_out[tag] = out
        new_paths[f"config1_{tag}_cli"] = launch
        mask_notes.append(
            f"{flag} {out.count(b'\n')} tabular lines (unmasked "
            f"{unmasked1.count(b'\n')}), cuda {t_cuda:.2f} s, cpu {t_cpu:.2f} "
            f"s, bytes equal")
    check(mask_out["db_soft_mask"] != mask_out["db_hard_mask"],
          "the soft and hard masks gave the same bytes")
    print(f"db masks (config 1): {len(ivs)} intervals of 300-3,000 bases, "
          f"{covered:.1%} of the genome; " + "; ".join(mask_notes)
          + f"; phase {time.time() - t_mask:.1f} s  [{card}]")

    # 6k. indexed megablast (ROADMAP item 13): makembindex over config 1's
    # database, then config 1 through the CLI with -use_index true, plain
    # and with -db_soft_mask: cuda bytes equal cpu bytes and the scanned
    # runs' bytes
    t_idx = time.time()
    for name in ("db", "db_mask"):
        check(cli_main(["makembindex", "-input", str(work / name)]) == 0,
              f"makembindex {name} failed")
    idx_notes = []
    for tag, db_name, extra, scanned in (
            ("index", "db", [], unmasked1),
            ("index_soft", "db_mask", ["-db_soft_mask", "40"],
             mask_out["db_soft_mask"])):
        args = c1_args + ["-db", str(work / db_name), "-use_index", "true",
                          *extra]
        out, launch, t_cuda, spans = card_run(args, work / f"{tag}.tsv")
        t_cpu = run_cli(args, "cpu", work / f"{tag}_cpu.tsv")
        check(out == (work / f"{tag}_cpu.tsv").read_bytes(),
              f"config 1 -use_index {extra}: cuda and cpu bytes differ")
        check(out == scanned, f"config 1 -use_index {extra}: the bytes "
                              "differ from the scanned run's")
        check("setup.index_upload" in spans,
              f"config 1 -use_index {extra}: the index was not used")
        check(launch[0] == launch[2] == launch[3] == 1,
              f"config 1 -use_index {extra}: launches K1/K2/G/R/RR {launch}")
        new_paths[f"config1_{tag}_cli"] = launch
        idx_notes.append(
            f"-use_index {' '.join(extra) or '(plain)'}: "
            f"{out.count(b'\n')} lines equal to the scan's, cuda "
            f"{t_cuda:.2f} s (setup.index_upload "
            f"{spans['setup.index_upload'] * 1e3:.1f} ms, device.seeding "
            f"{spans['device.seeding'] * 1e3:.1f} ms), cpu {t_cpu:.2f} s, "
            "bytes equal")
    print("db index (config 1): " + "; ".join(idx_notes)
          + f"; phase {time.time() - t_idx:.1f} s  [{card}]")

    # 6l. streaming (ROADMAP item 13's rest) at small blocks: configs 1,
    # 1w and 2d, config 1 with -db_soft_mask and config 1 with -use_index
    # through the CLI with GBLASTN_TPU_STREAM=1 and blocks of 2^20 bases:
    # cuda bytes equal the resident cuda bytes and the cpu bytes; K1 and G
    # (and RR at 1w) at most once a block with seeds in a batch, R once a
    # batch, no K2; no resident upload
    t_st = time.time()
    small = {"GBLASTN_TPU_STREAM": "1",
             "GBLASTN_TPU_BLOCK_BASES": str(1 << 20)}
    d_args = ["blastn", "-task", "dc-megablast", "-evalue", "1e-5",
              "-query", str(work / "config2d.fa"), "-db", str(work / "db"),
              "-outfmt", "6", "-max_target_seqs", "10"]
    n_small = -(-db.padded_length // (1 << 20))
    st_notes = []
    for tag, args, cuda_file, cpu_file, nb in (
            ("config1", c1_args + ["-db", str(work / "db")],
             "config1_cuda.tsv", "config1_cpu_b1.tsv", 1),
            ("config1w", ["blastn", "-task", "megablast", "-evalue", "1e-5",
                          "-window_size", "40", "-query",
                          str(work / "config1w.fa"), "-db", str(work / "db"),
                          "-outfmt", "6", "-max_target_seqs", "10"],
             "config1w_cuda.tsv", "config1w_cpu_b1.tsv", 1),
            ("config2d", d_args, "config2d_cuda.tsv", "config2d_cpu.tsv",
             cli_paths["config2d"]["batches"]),
            ("db_soft_mask", c1_args + ["-db", str(work / "db_mask"),
                                        "-db_soft_mask", "40"],
             "db_soft_mask.tsv", "db_soft_mask_cpu.tsv", 1),
            ("index", c1_args + ["-db", str(work / "db"), "-use_index",
                                 "true"], "index.tsv", "index_cpu.tsv", 1)):
        out, launch, t_cuda, spans = stream_run(
            args, work / f"{tag}_stream.tsv", small)
        check(out == (work / cuda_file).read_bytes(),
              f"streamed {tag}: the bytes differ from the resident run's")
        check(out == (work / cpu_file).read_bytes(),
              f"streamed {tag}: the bytes differ from the cpu run's")
        check(1 <= launch[0] <= nb * n_small and launch[1] == 0
              and launch[2] == launch[0] and 1 <= launch[3] <= nb
              and launch[4] == (launch[0] if tag == "config1w" else 0),
              f"streamed {tag}: launches K1/K2/G/R/RR {launch} over {nb} "
              f"batches of {n_small} blocks")
        check(tag != "index" or "setup.index_upload" not in spans,
              "the streamed index run uploaded the whole index")
        new_paths[f"{tag}_stream_cli"] = launch
        st_notes.append(
            f"{tag} {out.count(b'\n')} lines, K1 {launch[0]}, G "
            f"{launch[2]}, R {launch[3]} and RR {launch[4]} launches over "
            f"{nb} batches, cuda {t_cuda:.2f} s (device.seeding.stream "
            f"{spans['device.seeding.stream'] * 1e3:.1f} ms, host.diag_filter"
            f" {spans.get('host.diag_filter', 0.0) * 1e3:.1f} ms)")
    print(f"streamed at 2^20-base blocks ({n_small} blocks): "
          + "; ".join(st_notes) + f"; bytes equal to the resident cuda and "
          f"the cpu runs; phase {time.time() - t_st:.1f} s  [{card}]")

    # the -outfmt 6 rendering of a megablast search() result over ``tdb``
    from gblastn_tpu_torch.format.render import ResultRenderer

    def tabular(result, tdb):
        import io

        buf = io.StringIO()
        rr = ResultRenderer(6, None, buf, tdb, options, dbname="db",
                            task="megablast")
        rr.emit(result)
        rr.finalize()
        return buf.getvalue()

    # 6m. sharding (ROADMAP item 14) at GBLASTN_TPU_SHARDS=4, every shard
    # on the one card: (a) configs 1 and 2 through the CLI, bytes equal to
    # the unsharded cuda runs of phases 5 and 6 (which equal the cpu
    # bytes), K1 and G 4 times a batch, R once, K2 never, and the shards
    # uploaded by the first batch only; (b) 1w (RR on every shard) and 2d:
    # run_seeding_sharded's InitHits equal the resident run_seeding's, and
    # search() gives the unsharded HSPs; (c) config 1 with six 10 kb exact
    # reads planted across the three shard boundaries through search():
    # walks escalated, bytes equal; (d) two CLI processes over gloo on
    # localhost, both on cuda:0, on config 1: each rank's bytes equal the
    # unsharded ones, K1 and G twice a rank, R once. The 300 Mb batch at 4
    # shards follows phase 7's resident one.
    from gblastn_tpu_torch.parallel.dist import run_seeding_sharded

    t_sh = time.time()
    shard4 = {"GBLASTN_TPU_SHARDS": "4"}

    def shard_run(args, out):
        os.environ.update(shard4)
        try:
            got = card_run(args, out)
        finally:
            os.environ.pop("GBLASTN_TPU_SHARDS")
        spans = got[3]
        check("device.seeding.sharded" in spans
              and "setup.subject_upload" not in spans
              and "device.seeding.stream" not in spans,
              f"{out}: the batch was not sharded, or uploaded the resident "
              "form, or streamed")
        return got + (slog.counts.get("setup.shard_upload", 0),)

    sh_notes = []
    for tag, args, nb in (
            ("config1", c1_args + ["-db", str(work / "db")], 1),
            ("config2", ["blastn", "-task", "blastn", "-evalue", "1e-5",
                         "-query", str(work / "config2.fa"), "-db",
                         str(work / "db"), "-outfmt", "6",
                         "-max_target_seqs", "10"], n_batches)):
        out, launch, t_cuda, spans, uploads = shard_run(
            args, work / f"{tag}_shard.tsv")
        check(out == (work / f"{tag}_cuda.tsv").read_bytes(),
              f"sharded {tag}: the bytes differ from the unsharded run's")
        check(launch[0] == launch[2] == 4 * nb and launch[3] == nb
              and launch[1] == launch[4] == 0,
              f"sharded {tag}: launches K1/K2/G/R/RR {launch} over {nb} "
              "batches of 4 shards")
        check(uploads == 4, f"sharded {tag}: {uploads} shard uploads over "
                            f"{nb} batches (4 expected: the first batch's)")
        new_paths[f"{tag}_shard_cli"] = launch
        sh_notes.append(
            f"{tag} {out.count(b'\n')} lines over {nb} batches, K1 "
            f"{launch[0]} G {launch[2]} R {launch[3]} K2 {launch[1]}, "
            f"{uploads} shard uploads, cuda {t_cuda:.2f} s "
            f"(device.seeding.sharded "
            f"{spans['device.seeding.sharded'] * 1e3:.1f} ms, "
            f"setup.shard_upload {spans['setup.shard_upload'] * 1e3:.1f} ms)")
    print("sharded CLI at 4 shards: " + "; ".join(sh_notes)
          + f"; bytes equal to the unsharded cuda runs  [{card}]")

    for tag, (rs, _st, _ql) in (("config1w", two_hit["config1w"]),
                                ("config2d", two_hit["config2d"])):
        opts = config_options(tag)
        rb = setup_batch(rs, db, opts, dev)
        want_i = run_seeding(rb.seed_dev, **rb.seed_kw)
        del rb
        want_h = hsp_rows(search(rs, db, opts, device=dev))
        os.environ.update(shard4)
        try:
            b = setup_batch(rs, db, opts, dev)
            check(b.shards is not None and all(
                res_k.device == dev for res_k, _i in b.shards.forms.values()),
                f"{tag}: the batch was not sharded on the card")
            guard(True)
            counts_zero()
            try:
                got_i = run_seeding_sharded(b.shards, b.seed_dev, **b.seed_kw)
                launch = (k1.launches, k2.launches, kg.launches,
                          kr.launches, krr.launches)
                counts_zero()
                slog.reset()
                got_h = hsp_rows(search(rs, db, opts, device=dev))
                s_launch = (k1.launches, k2.launches, kg.launches,
                            kr.launches, krr.launches)
            finally:
                guard(False)
        finally:
            os.environ.pop("GBLASTN_TPU_SHARDS")
        same_init(got_i, want_i, f"{tag} at 4 shards against the resident "
                                 "run_seeding")
        check(got_h == want_h, f"{tag} at 4 shards: search() differs from "
                               "the unsharded search()")
        rr_want = 4 if tag == "config1w" else 0
        check(launch == (4, 0, 4, 1, rr_want) and s_launch == launch,
              f"{tag} at 4 shards: launches K1/K2/G/R/RR {launch} "
              f"(run_seeding_sharded), {s_launch} (search())")
        new_paths[f"{tag}_shard_search"] = s_launch
        print(f"{tag} at 4 shards: {len(got_i)} InitHits equal to the "
              f"resident run_seeding's, {len(got_h)} HSPs equal to the "
              f"unsharded search()'s; launches K1 {launch[0]} G {launch[2]} "
              f"R {launch[3]} RR {launch[4]}  [{card}]")
        del b

    # (c) six 10 kb exact reads across the three boundaries of config 1's
    # shard plan, two a boundary (one from each side, one of them on the
    # minus strand)
    os.environ.update(shard4)
    try:
        plan = setup_batch(reads, db, options, dev).shards.blocks.plan
        comp = str.maketrans("ACGT", "TGCA")
        edge_reads = []
        for k in (1, 2, 3):
            b0 = k * plan.B
            edge_reads.append(FastaRecord(f"edge{k}a", "",
                                          genome[b0 - 6000: b0 + 4000]))
            edge_reads.append(FastaRecord(
                f"edge{k}b", "",
                genome[b0 - 4000: b0 + 6000].translate(comp)[::-1]))
        planted = reads + edge_reads
        b = setup_batch(planted, db, options, dev)
        check(b.shards.blocks.plan.B == plan.B,
              "the planted batch's shard plan moved its boundaries")
        del b
        guard(True)
        counts_zero()
        slog.reset()
        t0 = time.time()
        try:
            got = search(planted, db, options, device=dev)
            torch.cuda.synchronize()
        finally:
            guard(False)
        t_planted = time.time() - t0
        p_launch = (k1.launches, k2.launches, kg.launches, kr.launches,
                    krr.launches)
        p_vals, p_spans = dict(slog.values), dict(slog.totals)
    finally:
        os.environ.pop("GBLASTN_TPU_SHARDS")
    want = search(planted, db, options, device=dev)
    check(tabular(got, db) == tabular(want, db),
          "config 1 with reads across the shard boundaries: the sharded "
          "bytes differ from the unsharded ones")
    n_esc = int(p_vals["seeding.shard_escalated"])
    check(n_esc > 0, "no walk was escalated across a shard boundary")
    edge_found = sum(
        any(h.q_end - h.q_off == 10000 for lst in q.hsplists
            for h in lst.hsps)
        for q in got.queries if q.query_index >= len(reads))
    check(edge_found == 6, f"{edge_found} of the 6 edge reads aligned whole")
    check(p_launch == (4, 0, 4, 1, 0),
          f"config 1 with edge reads: launches K1/K2/G/R/RR {p_launch}")
    new_paths["config1_edges_shard_search"] = p_launch
    print(f"config 1 with 6 reads across the shard boundaries at "
          f"{[k * plan.B for k in (1, 2, 3)]} (shards of {plan.B} bases, "
          f"halo {plan.halo}): bytes equal to the unsharded search's, each "
          f"edge read one whole HSP, {n_esc} walks escalated "
          f"({int(p_vals['seeding.shard_gate_edges'])} for G alone), "
          f"host.shard_escalate "
          f"{p_spans.get('host.shard_escalate', 0.0) * 1e3:.1f} ms, search "
          f"{t_planted:.2f} s  [{card}]")
    del got, want

    # (d) two ranks over gloo on localhost, both on cuda:0
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    rank_prog = (
        "import json, sys\n"
        "from gblastn_tpu_torch.cli.main import main\n"
        "from gblastn_tpu_torch.ops import gapped, replay, ungapped\n"
        "from gblastn_tpu_torch.utils.profiling import slog\n"
        "rc = main(sys.argv[1:])\n"
        "import torch, torch.distributed\n"
        "print(json.dumps({'rc': rc, 'device': str(torch.cuda.current_device()),"
        " 'world': torch.distributed.get_world_size(), 'launches': ["
        "ungapped.ungapped_extend_window.launches,"
        " gapped.banded_gapped_scores.launches, replay.approx_gate.launches,"
        " replay.diag_replay.launches, replay.right_run.launches],"
        " 'escalated': slog.values.get('seeding.shard_escalated', 0),"
        " 'gather_ms': 1e3 * slog.totals.get('host.shard_gather', 0.0)}))\n")
    t0 = time.time()
    env = {**os.environ, "PYTHONPATH": str(REPO), **shard4,
           "GBLASTN_TPU_COORDINATOR": f"localhost:{port}",
           "GBLASTN_TPU_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", rank_prog] + c1_args
        + ["-db", str(work / "db"), "-device", "cuda", "-out",
           str(work / f"config1_rank{r}.tsv")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**env, "GBLASTN_TPU_PROCESS_ID": str(r)}) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    t_ranks = time.time() - t0
    rank_notes = []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"rank {r} exited {p.returncode}: "
                                 f"{se[-2000:]}")
        rec = json.loads(so.strip().splitlines()[-1])
        check(rec["rc"] == 0 and rec["world"] == 2 and rec["device"] == "0",
              f"rank {r}: {rec}")
        check((work / f"config1_rank{r}.tsv").read_bytes()
              == (work / "config1_cuda.tsv").read_bytes(),
              f"rank {r}'s bytes differ from the unsharded run's")
        launch = tuple(rec["launches"])
        check(launch == (2, 0, 2, 1, 0),
              f"rank {r}: launches K1/K2/G/R/RR {launch} (2, 0, 2, 1, 0 "
              "expected: two shards a rank, one batch)")
        new_paths[f"config1_rank{r}_cli"] = launch
        rank_notes.append(f"rank {r} K1 {launch[0]} G {launch[2]} R "
                          f"{launch[3]}, {int(rec['escalated'])} escalated, "
                          f"host.shard_gather {rec['gather_ms']:.1f} ms")
    print("config 1 over two gloo ranks on cuda:0 at 4 shards: each rank's "
          "bytes equal the unsharded ones; " + "; ".join(rank_notes)
          + f"; both ranks {t_ranks:.1f} s with start-up; phase "
          f"{time.time() - t_sh:.1f} s  [{card}]")

    del genome, db, reads, reads2, reads2d

    # 7. scale: one 500-read batch against a 300 Mb resident genome
    t0 = time.time()
    rng3 = np.random.default_rng(SEED + 3)
    big = make_genome(rng3, BIG_GENOME_LEN)
    big_pairs, big_starts = sample_reads(rng3, big, BIG_BATCH, QUERY_LEN,
                                         "c")
    big_reads = [FastaRecord(n, "", s) for n, s in big_pairs]
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
        if any(h.s_off < st + QUERY_LEN and h.s_end > st
               for lst in q.hsplists for h in lst.hsps):
            found += 1
    check(found == len(big_reads),
          f"300 Mb: {len(big_reads) - found} reads missed their locus")
    peak = torch.cuda.max_memory_allocated()
    print(f"scale 300Mb: host db build {t_db:.1f} s, search "
          f"{t_search:.2f} s (cold, incl. resident upload) for "
          f"{len(big_reads)} reads, all loci found, peak device memory "
          f"{peak / 2**30:.2f} GiB  [{card}]")

    # 6m (continued). the 300 Mb batch at 4 shards, all on the card beside
    # the resident form: HSPs equal to the resident batch's; K1 and G once
    # a shard, R once, no K2; a cold batch (the shards' upload) and a warm
    # one (no upload) timed, each shard's resident bytes and the peak
    # device memory printed
    want_rows = hsp_rows(res)
    big_runs = []
    os.environ.update(shard4)
    try:
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            guard(True)
            counts_zero()
            slog.reset()
            t0 = time.time()
            try:
                got = search(big_reads, big_db, options, device=dev)
                torch.cuda.synchronize()
            finally:
                guard(False)
            big_runs.append((time.time() - t0, (
                k1.launches, k2.launches, kg.launches, kr.launches,
                krr.launches), dict(slog.totals), dict(slog.counts),
                torch.cuda.max_memory_allocated()))
            check(hsp_rows(got) == want_rows,
                  "300 Mb at 4 shards: the HSPs differ from the resident "
                  "batch's")
            del got
    finally:
        os.environ.pop("GBLASTN_TPU_SHARDS")
    forms = [v for v in big_db._torch_shards.values()
             if hasattr(v, "subject_w")]
    check(len(forms) == 4 and all(f.device == dev for f in forms),
          f"300 Mb: {len(forms)} shard forms, or a shard off the card")
    shard_bytes = [nbytes(f.packed, f.subject2, f.valid, f.subject_w,
                          f.starts, f.ends) for f in forms]
    del forms
    for (t_b, launch, spans_b, counts_b, _pk), cold in zip(big_runs,
                                                           (True, False)):
        check(launch == (4, 0, 4, 1, 0),
              f"300 Mb at 4 shards: launches K1/K2/G/R/RR {launch}")
        check(counts_b.get("setup.shard_upload", 0) == (4 if cold else 0),
              f"300 Mb at 4 shards: {counts_b.get('setup.shard_upload', 0)} "
              f"shard uploads in the {'cold' if cold else 'warm'} batch")
    new_paths["big_shard_search"] = big_runs[0][1]
    top_b = sorted(big_runs[1][2].items(), key=lambda kv: -kv[1])[:5]
    print(f"300 Mb at 4 shards: HSPs equal to the resident batch's; each "
          f"shard's resident bytes {shard_bytes}; search() cold "
          f"{big_runs[0][0]:.2f} s (setup.shard_upload "
          f"{big_runs[0][2]['setup.shard_upload'] * 1e3:.1f} ms), warm "
          f"{big_runs[1][0]:.2f} s, no shard uploaded ("
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in top_b)
          + f"); peak device memory {big_runs[0][4] / 2**30:.2f} GiB cold, "
          f"{big_runs[1][4] / 2**30:.2f} warm (the resident form "
          f"included); launches K1 4 G 4 R 1 K2 0  [{card}]")
    big_db._torch_shards.clear()

    # 7'. config 3s, bench.py bench_config3's streamed leg: the same 500
    # reads against the 300 Mb genome with GBLASTN_TPU_STREAM=1 and the
    # default blocks (3 of 2^27 bases), its resident form dropped first:
    # -outfmt 6 bytes equal the resident run's; K1 and G once a block, R
    # once, no K2; a cold batch (uploads) and a warm one (the block cache)
    # timed; the streamed InitHits equal the host finish's over the
    # resident K1 rows, field by field
    from gblastn_tpu_torch.engine.stream import (
        run_seeding_streamed,
        stream_bytes,
    )
    want3 = tabular(res, big_db)
    init3, t_host3, _n, _r = host_init(setup_batch(big_reads, big_db,
                                                   options, dev))
    big_db._torch_resident.clear()
    torch.cuda.empty_cache()
    os.environ["GBLASTN_TPU_STREAM"] = "1"
    runs3 = []
    try:
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            counts_zero()
            slog.reset()
            guard(True)
            t0 = time.time()
            try:
                res = search(big_reads, big_db, options, device=dev)
                torch.cuda.synchronize()
            finally:
                guard(False)
            runs3.append((time.time() - t0, (k1.launches, k2.launches,
                                             kg.launches, kr.launches,
                                             krr.launches),
                          dict(slog.totals), dict(slog.values),
                          torch.cuda.max_memory_allocated(),
                          torch.cuda.max_memory_reserved()))
            check(tabular(res, big_db) == want3,
                  "config 3s: the streamed bytes differ from the resident "
                  "run's")
        b3 = setup_batch(big_reads, big_db, options, dev)
        same_init(run_seeding_streamed(b3.stream, b3.seed_dev, **b3.seed_kw),
                  init3, "config 3s: streamed against the host finish")
        # the cold batch's peak reserve beside the block cache against
        # the streamed check's need
        cached3 = sum(c["bytes"]
                      for c in big_db._torch_stream_cache.values())
        need3 = stream_bytes(b3.stream.plan, big_db.num_seqs)
        work3 = runs3[0][5] - cached3
        check(work3 <= need3,
              f"config 3s: the streamed search reserved {runs3[0][5]} "
              f"bytes, {work3} beside its block cache, past its check's "
              f"{need3}")
        del b3
    finally:
        os.environ.pop("GBLASTN_TPU_STREAM")
    s3_launch, s3_spans, s3_vals = runs3[0][1], runs3[0][2], runs3[0][3]
    n3 = int(s3_vals["seeding.stream_blocks"])
    check(s3_launch == (n3, 0, n3, 1, 0) and n3 == 3,
          f"config 3s launches K1/K2/G/R/RR {s3_launch} over {n3} blocks")
    check("device.seeding.stream" in s3_spans
          and "setup.subject_upload" not in s3_spans,
          "config 3s did not stream, or uploaded the resident form")
    new_paths["config3s_search"] = s3_launch
    top3 = sorted(runs3[1][2].items(), key=lambda kv: -kv[1])[:5]
    print(f"config 3s (300 Mb streamed in {n3} blocks of 2^27 bases): bytes "
          f"equal to the resident run's ({want3.count(chr(10))} lines); "
          f"search() cold {runs3[0][0]:.2f} s (upload "
          f"{s3_spans.get('device.seeding.stream.upload', 0.0) * 1e3:.1f} "
          f"ms), warm {runs3[1][0]:.2f} s ("
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in top3)
          + f"); {int(s3_vals['seeding.stream_escalated'])} seeds escalated"
          f" ({int(s3_vals['seeding.stream_gate_edges'])} for G alone); "
          f"InitHits equal to the host finish's ({t_host3:.2f} s); "
          f"peak reserve {work3} beside the block cache "
          f"({100 * work3 / need3:.1f}% of the streamed need {need3}); "
          f"peak device memory {runs3[0][4] / 2**30:.2f} GiB against "
          f"{peak / 2**30:.2f} resident; launches K1 {s3_launch[0]} K2 "
          f"{s3_launch[1]} G {s3_launch[2]} R {s3_launch[3]}  [{card}]")

    del big_db, res, big_reads
    torch.cuda.empty_cache()

    # 7a. genome scale (ROADMAP item 13): giant (bench.py's config 4, one
    # random subject of 3.2 Gbases) and chroms (GRCh38's 24 primary
    # chromosomes' lengths, 3.09 Gbases), 100 planted 1 kb reads each,
    # megablast through search() on one card with the whole database
    # resident and int64 coordinates
    from gblastn_tpu_torch.tools.workloads import (
        chroms_workload,
        giant_workload,
    )

    # 7b. the genome-scale path's kernels past 2^31 against their plain
    # versions, one launch alone timed: K1, G, RR (its wide kernel: the
    # subject's words pass 2^31) and R's one-hit and two-hit kernels on
    # int64 coordinates, on a single random subject of 2^31 + 2^22 bases
    # made on the card (replay_sets.past_2g_cases)
    t0 = time.time()
    far = replay_sets.past_2g_cases(dev)
    check(far["rr"][0][1].numel() * 16 > 1 << 31,
          "the past-2^31 subject's words do not pass 2^31")
    k1_far = compare_k1(far["k1"][0], "past 2^31", card, 20)
    g_far = compare_gate(*far["g"], "past 2^31", card, 20)
    rr_far = compare_run(*far["rr"], "past 2^31", card, 20)
    r_far = compare_replay(*far["r"], "past 2^31, one-hit", card, 20)
    r2_far = compare_replay(*far["r_two_hit"], "past 2^31, two-hit", card,
                            20)
    del far
    torch.cuda.empty_cache()
    print(f"past 2^31: {time.time() - t0:.1f} s  [{card}]")

    for tag, make in (("giant", giant_workload), ("chroms", chroms_workload)):
        t0 = time.time()
        made = make()
        g_db, g_pairs, g_plants = made[:3]
        g_owner = made[3] if len(made) > 3 else [0] * len(g_pairs)
        t_db = time.time() - t0
        new_paths[f"{tag}_search"], init, n_far = genome_phase(
            tag, g_db, g_pairs, g_plants, g_owner, t_db)
        if tag == "giant":
            new_paths["giant_stream_search"] = giant_streamed(
                g_db, g_pairs, g_plants, g_owner, init, n_far)
        del made, g_db, init
        torch.cuda.empty_cache()

    # slice 2's main path is config 2 through the CLI; K1 and K2 are
    # timed at its shapes (K1 also at config 1's); the table gather's
    # path is prof_scan_parts, and it is timed at P3's shape
    paths = {"config1_cli": c1_launches, "config2_search": s_launch,
             "config2_cli": c2_launches, "config2d_search": d_launch,
             **{f"{t}_cli": c["launches"] for t, c in cli_paths.items()},
             **new_paths}
    k2_err = max([k2_c2[0]] + [r[0] for r in k2_rand])
    g_recs = {"config2": g_c2, "config1": g_c1, "random": g_rand,
              **g2_recs, "past2g": g_far}
    r_recs = {"config2": r_c2, "config1": r_c1,
              **{f"random{i}": r for i, r in enumerate(r_rand)},
              **r2_recs,
              **{f"random_two_hit{i}": r for i, r in enumerate(r2_rand)},
              "past2g": r_far, "past2g_two_hit": r2_far}
    rr_all = {**rr_recs, "random11": rr_rand[0], "random28": rr_rand[1],
              "past2g": rr_far}
    print(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} "
          f"s  [{card}]")
    print(smi)
    print(json.dumps({"kernels": [
        k1_entry(k1_c2, k1_c1, k1_rand, c2_launches[0],
                 {p: c[0] for p, c in paths.items()}, regs["K1"],
                 {"config2d": k1_2d, "past2g": k1_far}),
        {"name": "gapped_band", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": c2_launches[1],
         "max_abs_err": k2_err, "ms": k2_c2[1], "plain_ms": k2_c2[2],
         "bound_ms": k2_c2[3], "bound_by": k2_c2[4], "library_ms": None,
         "ms_graph": k2_c2[5],
         "ms_graph_random": [r[5] for r in k2_rand],
         "launches_by_path": {**{p: c[1] for p, c in paths.items()},
                              "prof_gapped_parity": pg_launches[1]}},
        gather_entry(psp["gather"], psp_launches[2], psp["sweep"]),
        finish_entry("approx_gate", G_SOURCE, G_REPLACES, g_recs,
                     c2_launches[2], {p: c[2] for p, c in paths.items()},
                     regs["G"], sorts=r_c2),
        finish_entry("diag_replay", R_SOURCE, R_REPLACES, r_recs,
                     c2_launches[3], {p: c[3] for p, c in paths.items()},
                     regs["R"], sorts=r_c2),
        finish_entry("right_run", RR_SOURCE, RR_REPLACES, rr_all,
                     cli_paths["config1w"]["launches"][4],
                     {p: c[4] for p, c in paths.items()}, regs["RR"],
                     main="config1w"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
