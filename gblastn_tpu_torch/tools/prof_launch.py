"""K2, K1, G and R one launch alone, at the search path's shapes.

Builds config 2's workload on the card (bench.py's genome and seed, 200 x
1.5 kb reads of seed + 2, ``-task blastn``: the candidates' K2 jobs and
the K1 seeds, as ``chip_smoke.py`` does) and times one launch of each
kernel from a CUDA graph of 100 (``tools.timing.graph_ms``):

  * K2, this tree's wrapper, at config 2's jobs, at its longest job alone
    (one warp's row chain) and at prof_gapped's alive and dead workloads,
    beside its wrapper call (CUDA events);
  * with ``--parent DIR``, the K2 of another checkout (DIR's
    ``gblastn_tpu_torch/csrc/gapped_band.cu``, built alone and launched
    through its C entry, which takes the jobs' launch order), held
    bit-equal to this tree's and timed in turns: parent, this tree, this
    tree, parent;
  * K1's wrapper at config 1's and config 2's seeds, held bit-equal to
    its plain version, beside its wrapper call (CUDA events); with
    ``--parent DIR`` DIR's K1 (its ``csrc/ungapped_xdrop.cu``, built
    alone and launched through its C entry, which takes the query's and
    the subject's lengths), held bit-equal too and timed in the same
    turns: parent, this tree, this tree, parent;
  * the device finish's G and R (ops/replay.py) at config 1's and config
    2's search-path inputs (``tools.replay_sets.batch_cases``), and with
    two-hit seeding at configs 1w, 2w and 2d (``prof_e2e``'s: window 40;
    dc-megablast), each held bit-equal to its plain version and timed as
    one launch alone and as a wrapper call, with ``replay_keys``' two
    forms that order R's seeds (one sort of the packed key, two sorts)
    timed beside them; with ``--parent DIR`` DIR's G and R (its
    ``csrc/approx_gate.cu`` and ``csrc/diag_replay.cu``, each built alone
    and launched through its C entry; R on the one-sort order), held
    bit-equal too and timed in the same turns. G and R come first;
    a parent whose kernels take int32 subject offsets (the C entries
    before they widened to int64, ``parent_wide``) gets int32 copies of
    those arrays, made before the turns;
  * RR at config 1w (the one path that probes double words;
    ``batch_run_case``) and on its random sets at words 11 and 28
    (``random_run_cases``), held bit-equal to its plain version, one
    launch alone beside an empty kernel's at the same grid (the launch
    floor, ``timing.launch_floor_ms``) and a wrapper call; with
    ``--parent DIR`` DIR's RR (its ``csrc/right_run.cu``, built alone and
    launched through its C entry) held bit-equal too and timed in the
    turns parent, this, this, parent, and, where DIR holds
    ``gblastn_tpu_torch/ops/replay.py``, that file's ``right_run``
    wrapper around this tree's kernel timed as a call beside this tree's
    (the host work of a call before and after).

Run on the card:
    python -m gblastn_tpu_torch.tools.prof_launch [--parent DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

from gblastn_tpu_torch.ops import _build
from gblastn_tpu_torch.ops import gapped as og
from gblastn_tpu_torch.ops import ungapped as ung
from gblastn_tpu_torch.tools import prof_gapped
from gblastn_tpu_torch.tools.timing import (
    call_ms,
    device_label,
    graph_ms,
    launch_floor_ms,
)
from gblastn_tpu_torch.tools.workloads import C2_QUERIES, C2_QUERY_LEN


def _raw_stream(dev):
    return torch._C._cuda_getCurrentRawStream(dev.index)


def search_shapes(dev):
    """(K1 args at config 1, K1 args at config 2, K2 (args, keywords) at
    config 2's candidates, {"config1": ..., "config2": ...} of G's and
    R's inputs (``tools.replay_sets.batch_cases``)): the inputs the search
    path gives the kernels."""
    from gblastn_tpu_torch import (
        FastaRecord,
        SequenceDB,
        blastn_options,
        megablast_options,
    )
    from gblastn_tpu_torch.engine.gapped import gapped_filter_jobs
    from gblastn_tpu_torch.engine.search import (
        _build_gapped_filter,
        setup_batch,
    )
    from gblastn_tpu_torch.engine.seeding import run_seeding, ungapped_inputs
    from gblastn_tpu_torch.tools.workloads import (
        GENOME_LEN,
        NUM_QUERIES,
        QUERY_LEN,
        SEED,
        make_genome,
        sample_reads,
    )

    rng = np.random.default_rng(SEED)
    genome = make_genome(rng, GENOME_LEN)
    pairs, _ = sample_reads(rng, genome, NUM_QUERIES, QUERY_LEN, "w0_")
    db = SequenceDB.from_records([FastaRecord("ecoli_synth", "", genome)],
                                 title="ecoli_synth")
    b1 = setup_batch([FastaRecord(n, "", s) for n, s in pairs], db,
                     megablast_options(evalue=1e-5, max_target_seqs=10), dev)
    k1_c1 = ungapped_inputs(b1.seed_dev, **b1.seed_kw)[1]
    rng2 = np.random.default_rng(SEED + 2)
    pairs2, _ = sample_reads(rng2, genome, C2_QUERIES, C2_QUERY_LEN, "b")
    reads2 = [FastaRecord(n, "", s) for n, s in pairs2]
    b2 = setup_batch(reads2, db,
                     blastn_options(evalue=1e-5, max_target_seqs=10), dev)
    k1_c2 = ungapped_inputs(b2.seed_dev, **b2.seed_kw)[1]
    init = run_seeding(b2.seed_dev, **b2.seed_kw)
    dgd = _build_gapped_filter(b2)
    jobs = gapped_filter_jobs(init, b2.qblock, db.starts, db.lengths,
                              b2.params, dgd)
    k2 = ((dgd.query, dgd.subject2, dgd.matrix16, jobs),
          dict(rows=dgd.rows, gap_open=dgd.gap_open,
               gap_extend=dgd.gap_extend))
    from gblastn_tpu_torch.tools.prof_e2e import config_options
    from gblastn_tpu_torch.tools.replay_sets import (
        batch_cases,
        batch_key_case,
        batch_run_case,
    )
    from gblastn_tpu_torch.tools.workloads import config2d_reads

    reads1 = [FastaRecord(n, "", s) for n, s in pairs]
    reads2d = [FastaRecord(n, "", s)
               for n, s in config2d_reads(genome)[0]]

    def case(b):
        c = batch_cases(b)
        return c, batch_run_case(b), batch_key_case(b, *c[:3])
    finish = {"config1": case(b1), "config2": case(b2)}
    for name, reads in (("config1w", reads1), ("config2w", reads2),
                        ("config2d", reads2d)):
        finish[name] = case(setup_batch(reads, db, config_options(name),
                                        dev))
    return k1_c1, k1_c2, k2, finish


def finish_times(cases, label, parent=None):
    """G and R at each case of ``search_shapes``' fourth item, each held
    bit-equal to its plain version: one launch alone, this tree's wrapper
    and, with ``parent`` (``parent_finish``' libraries), the parent's
    kernels through their C entries, in the turns parent, this, this,
    parent; where a case's coordinates are int32, R's wide kernels on
    int64 copies of them ("wide", after "this" in the same turns);
    their wrapper calls; and ``replay_keys``' one-sort and
    two-sort forms (a call, CUDA events). Prints a line a case and
    returns (records, all bit-equal)."""
    from gblastn_tpu_torch.ops import replay as rp

    rec, ok = {}, True
    for name, ((g_args, g_kw, r_args, r_kw), _run_case, keys) in (
            cases.items()):
        g_want = rp.approx_gate_ref(*g_args, **g_kw)
        r_want = rp.diag_replay_ref(*r_args, **r_kw)
        k_args, k_kw = keys
        g_launch, r_launch = {}, {}
        g_outs = {"this": []}
        r_outs = {"this": []}

        def g_this():
            g_outs["this"][:] = rp.approx_gate(*g_args, **g_kw)

        def r_this():
            r_outs["this"][:] = [rp.diag_replay(*r_args, **r_kw)]
        if parent is not None:
            g_launch["parent"], g_outs["parent"] = gate_c_launch(
                parent["g"], g_args, g_kw, parent["wide"]["g"])
            r_launch["parent"], r_outs["parent"] = replay_c_launch(
                parent["r"], r_args, r_kw, parent["wide"]["r"])
        g_launch["this"], r_launch["this"] = g_this, r_this
        if r_args[2].dtype == torch.int32:
            # R's wide kernels on int64 copies of the coordinates
            wide_args = (*r_args[:2], r_args[2].long(), r_args[3].long(),
                         *r_args[4:])
            r_outs["wide"] = []

            def r_wide():
                r_outs["wide"][:] = [rp.diag_replay(*wide_args, **r_kw)]
            r_launch["wide"] = r_wide
        g_ms = turns(g_launch, (rp.approx_gate,))
        r_ms = turns(r_launch, (rp.diag_replay,))
        torch.cuda.synchronize()
        g_same = all(_same(o, g_want) for o in g_outs.values())
        r_same = all(_same(o, (r_want,)) for o in r_outs.values())
        ok &= g_same and r_same
        g_call = call_ms(lambda: rp.approx_gate(*g_args, **g_kw), 20, "cuda")
        r_call = call_ms(lambda: rp.diag_replay(*r_args, **r_kw), 20, "cuda")
        sort_one = call_ms(lambda: rp.replay_keys(*k_args, **k_kw), 20,
                           "cuda")
        sort_two = call_ms(
            lambda: rp.replay_keys(*k_args, **k_kw, two_sorts=True), 20,
            "cuda")
        n = g_args[6].numel()
        rec[name] = {"seeds": n, "gate_ms_graph": g_ms,
                     "gate_ms_call": g_call, "replay_ms_graph": r_ms,
                     "replay_ms_call": r_call, "sort_ms_call": sort_one,
                     "sort_two_ms_call": sort_two,
                     "key_shift": r_kw["key_shift"],
                     "bit_equal": bool(g_same and r_same)}
        print(f"finish {name}: {n} seeds, window {r_kw['window']}; G one "
              f"launch {_fmt(g_ms)} ms, a call {g_call:.4f}; R one launch "
              f"{_fmt(r_ms)} ms, a call {r_call:.4f}; replay_keys one sort "
              f"{sort_one:.4f} ms a call (key_shift {r_kw['key_shift']}), "
              f"two sorts {sort_two:.4f}; bit-equal {g_same and r_same}"
              f"  [{label}]", flush=True)
    return rec, ok


def rr_times(cases, label, parent=None, parent_wrapper=None,
             parent_wide=True):
    """RR at each of ``cases`` ({name: (args, kw)} of ``right_run``), held
    bit-equal to its plain version: one launch alone (a CUDA graph of
    100) of this tree's wrapper and, with ``parent`` (a library from
    ``_build.build_one``; its entry int64 where ``parent_wide``), of the
    parent's kernel through its C entry, in
    the turns parent, this, this, parent; an empty kernel's launch at
    the same grid (the launch floor); a wrapper call (CUDA events) and,
    with ``parent_wrapper`` (``parent_right_run``), the parent's wrapper
    call around this tree's kernel, in the turns parent, this, this,
    parent. Prints a line a case and returns (records, all bit-equal)."""
    from gblastn_tpu_torch.ops import replay as rp

    rec, ok = {}, True
    for name, (a, kw) in cases.items():
        want = rp.right_run_ref(*a, **kw)
        n = a[3].numel()
        outs = {"this": []}

        def this():
            outs["this"][:] = [rp.right_run(*a, **kw)]
        launches = {}
        if parent is not None:
            launches["parent"], outs["parent"] = rr_c_launch(
                parent, a, kw, parent_wide)
        launches["this"] = this
        one = turns(launches, (rp.right_run,))
        torch.cuda.synchronize()
        same = all(_same(o, (want,)) for o in outs.values())
        ok &= same
        floor = launch_floor_ms(-(-n // 256))
        calls = {}
        wrappers = {"this": rp.right_run}
        if parent_wrapper is not None:
            wrappers = {"parent": parent_wrapper, **wrappers}
            same_w = torch.equal(parent_wrapper(*a, **kw), want)
            ok &= same_w
            same &= same_w
        for who in list(wrappers) + list(wrappers)[::-1]:
            calls.setdefault(who, []).append(call_ms(
                lambda: wrappers[who](*a, **kw), 20, "cuda"))
        rec[name] = {"seeds": n, "ms_graph": one, "ms_call": calls,
                     "launch_floor_ms": floor, "bit_equal": bool(same)}
        print(f"rr {name}: {n} seeds, word {kw['word_size']}; one launch "
              f"{_fmt(one)} ms; an empty kernel at the same grid "
              f"{floor:.4f} ms; a wrapper call {_fmt(calls)}; bit-equal "
              f"{same}  [{label}]", flush=True)
    return rec, ok


def _fmt(ms):
    return ", ".join(f"{w} " + " / ".join(f"{t:.4f}" for t in v)
                     for w, v in ms.items())


def turns(launches, counted):
    """One launch alone (ms, from a CUDA graph of 100) of each of
    ``launches`` ({name: fn}), in the turns given by their order and then
    the reverse (parent, this, ..., this, parent): {name: [ms, ms]}.
    ``counted`` are the wrappers whose launches "this" counts."""
    order = list(launches)
    ms = {}
    for who in order + order[::-1]:
        ms.setdefault(who, []).append(graph_ms(
            launches[who], counted=counted if who == "this" else ()))
    return ms


# the marker of each C entry that takes int64 subject offsets (this
# tree's), in its source's text
_WIDE_MARKS = {"k1": "long long S,", "g": "long long P,",
               "r": "int wide,", "rr": "long long S16,"}


def parent_wide(src: dict[str, Path]) -> dict[str, bool]:
    """For each of ``parent_sources``' kernels, whether its C entry takes
    int64 subject offsets, as this tree's do (else the int32 entries
    before them): {"k1": bool, ...}, from the source's text."""
    return {k: _WIDE_MARKS[k] in Path(src[k]).read_text()
            for k in _WIDE_MARKS}


def _narrow(t):
    return t.to(torch.int32) if t.dtype == torch.int64 else t


def gate_c_launch(lib, args, kw, wide=True):
    """fn() launching G through the C entry of ``lib`` (a library from
    ``_build.build_one``: the parent's kernel or a variant of this
    tree's; the entry's arguments are the wrapper's, with int32 copies of
    s_off and s_start and an int P where ``wide`` is false) on the
    current stream, and its five outputs."""
    fn = lib.gblastn_approx_gate
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int]
                   + [ctypes.c_longlong if wide else ctypes.c_int]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6)
    if not wide:
        args = tuple(_narrow(t) if k in (7, 11) else t
                     for k, t in enumerate(args))
    qbytes, packed, _tab, ctx_tables, sub_starts = args[:5]
    n = args[6].numel()
    dev = qbytes.device
    outs = list(torch.empty((5, n), dtype=torch.int32, device=dev).unbind(0))
    if wide:
        outs[1] = torch.empty(n, dtype=torch.int64, device=dev)
    runs = kw.get("right_run")
    ptrs = (*(t.data_ptr() for t in args),
            runs.data_ptr() if runs is not None else None, qbytes.numel(),
            packed.numel(), ctx_tables.shape[1], sub_starts.numel(), n,
            kw["word_size"], kw["concat_end"], *(o.data_ptr() for o in outs))

    def launch(_keep=args):    # keeps the int32 copies alive
        rc = fn(*ptrs, _raw_stream(dev))
        if rc != 0:
            raise RuntimeError(f"G launch failed: CUDA error {rc}")
    return launch, outs


def replay_c_launch(lib, args, kw, wide=True):
    """fn() launching R through the C entry of ``lib`` (the parent's
    kernel, a library from ``_build.build_one``; its entry takes
    key_shift, as this tree's does, and where ``wide`` the coordinates'
    width; an older entry int32 coordinates alone) on the current stream,
    and its saved output (in a list)."""
    fn = lib.gblastn_diag_replay
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * (5 if wide
                                                            else 4)
                   + [ctypes.c_void_p] * 2)
    if not wide:
        args = tuple(_narrow(t) if k in (2, 3) else t
                     for k, t in enumerate(args))
    n = args[0].numel()
    dev = args[0].device
    window = kw.get("window", 0)
    runs = kw.get("right_run") if window else None
    saved = torch.zeros(n, dtype=torch.uint8, device=dev)
    ptrs = (*(t.data_ptr() for t in args),
            runs.data_ptr() if runs is not None else None,
            n, kw["word_size"], window, kw["key_shift"],
            *((int(args[2].dtype == torch.int64),) if wide else ()))

    def launch(_keep=args):    # keeps the int32 copies alive
        saved.zero_()
        rc = fn(*ptrs, saved.data_ptr(), _raw_stream(dev))
        if rc != 0:
            raise RuntimeError(f"R launch failed: CUDA error {rc}")
    return launch, [saved]


def rr_c_launch(lib, args, kw, wide=True):
    """fn() launching RR through the C entry of ``lib`` (the parent's
    kernel, a library from ``_build.build_one``; its entry's arguments
    are the wrapper's, with an int32 copy of s_off and an int S16 where
    ``wide`` is false) on the current stream, and its runs (in a
    list)."""
    fn = lib.gblastn_right_run
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                   + [ctypes.c_longlong if wide else ctypes.c_int]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    if not wide:
        args = tuple(_narrow(t) if k == 4 else t for k, t in enumerate(args))
    query_nib, subject_w, sub_ends, q_off = args[:4]
    n = q_off.numel()
    dev = q_off.device
    run = torch.empty(n, dtype=torch.int32, device=dev)
    ptrs = (*(t.data_ptr() for t in args), query_nib.numel(),
            subject_w.numel(), sub_ends.numel(), n, kw["word_size"],
            run.data_ptr())

    def launch(_keep=args):    # keeps the int32 copies alive
        rc = fn(*ptrs, _raw_stream(dev))
        if rc != 0:
            raise RuntimeError(f"RR launch failed: CUDA error {rc}")
    return launch, [run]


def parent_right_run(parent: Path):
    """The ``right_run`` wrapper of the parent checkout's
    ``gblastn_tpu_torch/ops/replay.py``, loaded as a module of its own
    (it binds this tree's kernel library: a call then differs from this
    tree's by its host work alone), or None where DIR holds no such
    file."""
    path = Path(parent) / "gblastn_tpu_torch" / "ops" / "replay.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location("_parent_replay", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.right_run


def parent_finish(src):
    """The parent's G, R and RR (``parent_sources``' "g", "r" and
    "rr"), each built alone: {"g": library, "r": library, "rr":
    library, "wide": ``parent_wide(src)``}."""
    return {"g": _build.build_one(src["g"], "approx_gate_parent"),
            "r": _build.build_one(src["r"], "diag_replay_parent"),
            "rr": _build.build_one(src["rr"], "right_run_parent"),
            "wide": parent_wide(src)}


def longest_job(jobs, q_len, s_len, rows):
    """The job set's first job in launch order (the longest row budget),
    alone: what one warp's row chain takes without the rest."""
    j = int(jobs.order[0])
    one = og.GappedJobs(*(t[j: j + 1].cpu() for t in (
        jobs.a0, jobs.b0, jobs.m, jobs.n, jobs.x)),
        n_right=int(j < jobs.n_right))
    return og.check_jobs(one, q_len, s_len, rows).to(jobs.m.device)


def parent_sources(parent: Path) -> dict[str, Path]:
    """The parent checkout's kernel sources that ``--parent`` builds:
    {"k1": ungapped_xdrop.cu, "k2": gapped_band.cu, "g": approx_gate.cu,
    "r": diag_replay.cu, "rr": right_run.cu}. FileNotFoundError names a
    missing one before anything is built or launched."""
    csrc = Path(parent) / "gblastn_tpu_torch" / "csrc"
    out = {"k1": csrc / "ungapped_xdrop.cu", "k2": csrc / "gapped_band.cu",
           "g": csrc / "approx_gate.cu", "r": csrc / "diag_replay.cu",
           "rr": csrc / "right_run.cu"}
    for path in out.values():
        if not path.is_file():
            raise FileNotFoundError(f"--parent: no {path}")
    return out


def k1_parent_launch(lib, args, wide=True):
    """fn() launching the parent commit's K1 (a library from
    ``_build.build_one``; its C entry takes the query's and the subject's
    lengths, as this tree's does, and where ``wide`` is false int32
    subject offsets, given an int32 copy of s_off) on the current
    stream, and its five outputs."""
    fn = lib.gblastn_ungapped_xdrop
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong if wide else ctypes.c_int]
                   + [ctypes.c_void_p] * 6)
    if not wide:
        args = tuple(_narrow(t) if k == 4 else t for k, t in enumerate(args))
    dev = args[0].device
    n = args[3].numel()
    outs = [torch.empty(n, dtype=torch.int64 if k == 1 and wide
                        else torch.int32, device=dev) for k in range(5)]
    ptrs = [a.data_ptr() for a in args]
    optrs = [o.data_ptr() for o in outs]

    def launch(_keep=args):    # keeps the int32 copies alive
        rc = fn(*ptrs, n, args[0].numel(), args[1].numel(), *optrs,
                _raw_stream(dev))
        if rc != 0:
            raise RuntimeError(f"parent K1 launch failed: CUDA error {rc}")
    return launch, outs


def k1_turns(args, parent=None, wide=True):
    """One launch of K1 alone (ms, from a CUDA graph of 100) at ``args``:
    this tree's wrapper ("this") and, when ``parent`` is its library (its
    entry int64 where ``wide``), the parent's kernel, in the turns
    parent, this, this, parent. Returns (ms lists by name, bit-equal:
    every launch's outputs equal the plain version's)."""
    want = ung.ungapped_extend_window_ref(*args)
    outs, launches = {}, {}
    if parent is not None:
        launches["parent"], outs["parent"] = k1_parent_launch(parent, args,
                                                              wide)
    last = outs.setdefault("this", [])

    def launch():
        last[:] = ung.ungapped_extend_window(*args)
    launches["this"] = launch
    ms = turns(launches, (ung.ungapped_extend_window,))
    torch.cuda.synchronize()
    same = all(_same(o, want) for o in outs.values())
    return ms, same


def k2_launch(lib, args, kw):
    """fn() launching the parent commit's K2 (a library from
    ``_build.build_one``; its C entry takes the jobs' launch order, as
    this tree's does) on the current stream, and its (score, flags)."""
    fn = lib.gblastn_gapped_band
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
    query, subject2, matrix16, jobs = args
    dev = query.device
    J = len(jobs)
    score = torch.empty(J, dtype=torch.int32, device=dev)
    flags = torch.empty(J, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (query, subject2, matrix16, jobs.a0,
                                   jobs.b0, jobs.m, jobs.n, jobs.x,
                                   jobs.order)]
    ints = (J, jobs.n_right, kw["rows"], kw["gap_open"], kw["gap_extend"])

    def launch():
        rc = fn(*ptrs, *ints, score.data_ptr(), flags.data_ptr(),
                _raw_stream(dev))
        if rc != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {rc}")
    return launch, (score, flags)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gblastn_tpu_torch.tools.prof_launch",
        description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose K1, K2, G, R and RR to time "
                         "beside this tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_launch: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    label = device_label(dev)
    print(f"device: {label}")
    rec = {"device": label}
    ok = True

    k1_c1, k1_c2, (k2_args, k2_kw), finish = search_shapes(dev)
    pf = parent_finish(parent_sources(args.parent)) if args.parent else None
    fin, same = finish_times(finish, label, pf)
    rec["finish"] = fin
    ok &= same
    from gblastn_tpu_torch.tools.replay_sets import random_run_cases

    rr_cases = {name: c[1] for name, c in finish.items()
                if c[1] is not None}
    rr_cases.update({f"random{kw['word_size']}": (a, kw)
                     for _label, a, kw in random_run_cases(dev)})
    rr, same = rr_times(
        rr_cases, label, pf["rr"] if pf else None,
        # an older wrapper would hand this tree's kernel int32 offsets
        parent_right_run(args.parent)
        if args.parent and pf["wide"]["rr"] else None,
        pf["wide"]["rr"] if pf else True)
    rec["rr"] = rr
    ok &= same
    q, s2, mat, kw_pg, sets = prof_gapped.workload(dev, n_sets=1)
    k2_cases = {"config2": (k2_args, k2_kw),
                "config2_longest": (k2_args[:3] + (longest_job(
                    k2_args[3], k2_args[0].numel(), k2_args[1].numel(),
                    k2_kw["rows"]),), k2_kw),
                "alive": ((q, s2, mat, sets["alive"][0]), kw_pg),
                "dead": ((q, s2, mat, sets["dead"][0]), kw_pg)}

    parent = parent_k2 = None
    k1_wide = True
    if args.parent is not None:
        src = parent_sources(args.parent)
        parent = _build.build_one(src["k1"], "ungapped_xdrop_parent")
        parent_k2 = _build.build_one(src["k2"], "gapped_band_parent")
        k1_wide = parent_wide(src)["k1"]

    for name, a in (("config1", k1_c1), ("config2", k1_c2)):
        n = a[3].numel()
        one, same = k1_turns(a, parent, k1_wide)
        ok &= same
        call = call_ms(lambda: ung.ungapped_extend_window(*a), 20, "cuda")
        rec[f"k1_{name}"] = {"seeds": n, "ms_graph": one, "ms_call": call,
                             "bit_equal": same}
        print(f"k1 {name}: {n} seeds, one launch {_fmt(one)} ms; wrapper "
              f"call {call:.4f} ms; bit-equal {same}  [{label}]", flush=True)

    for name, (a, kw) in k2_cases.items():
        want = og.banded_gapped_scores(*a, **kw)
        launches = {"this": lambda: og.banded_gapped_scores(*a, **kw)}
        if parent_k2 is not None:
            launch, out = k2_launch(parent_k2, a, kw)
            launch()
            same = _same(out, want)
            ok &= same
            print(f"k2 {name} parent: bit-equal {same}", flush=True)
            launches = {"parent": launch, **launches}
        one = turns(launches, (og.banded_gapped_scores,))
        call = call_ms(lambda: og.banded_gapped_scores(*a, **kw), 20, "cuda")
        rec[f"k2_{name}"] = {"jobs": len(a[3]), "ms_graph": one,
                             "ms_call": call}
        print(f"k2 {name}: {len(a[3])} jobs, rows {kw['rows']}, one launch "
              f"{_fmt(one)} ms; wrapper call {call:.4f} ms  [{label}]",
              flush=True)
    rec["ok"] = bool(ok)
    print(json.dumps(rec))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
