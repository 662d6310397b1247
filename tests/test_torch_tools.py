"""The port's profilers (gblastn_tpu_torch.tools) on the CPU: the
two-depth arithmetic of loop_timer on a stage of known cost, each tool's
main() run in-process at a small size, and no tool falling back to the
CPU when a card is asked for and missing."""
from __future__ import annotations

import types
from pathlib import Path

import pytest
import torch

from gblastn_tpu_torch.tools import (
    prof_e2e,
    prof_gapped,
    prof_launch,
    prof_scan_parts,
    prof_scan_rate,
    timing,
)

REPO = Path(__file__).resolve().parents[1]

# the plain versions run many small ops: on the CPU one thread beats a pool
torch.set_num_threads(1)


@pytest.mark.parametrize("cost_ms", [2.0, 5.0])
def test_loop_timer_gives_the_cost_of_one_iteration(cost_ms, monkeypatch,
                                                    capsys):
    """On a clock that each iteration advances by cost_ms and each clock
    read by 3.5 ms (a fixed cost in every timed run), T(K2) - T(K1) over
    K2 - K1 is cost_ms exactly: what a run pays once cancels."""
    clock = {"now": 100.0}

    def perf_counter():
        t = clock["now"]
        clock["now"] += 3.5e-3
        return t

    monkeypatch.setattr(timing, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))
    calls = []

    def stage(x):
        calls.append(x.clone())
        clock["now"] += cost_ms / 1e3
        return x.sum()

    base = torch.zeros(64, dtype=torch.int8)
    ms = timing.loop_timer(stage, "known-cost stage", 1e6, "Gunit/s",
                           device=torch.device("cpu"), base=base)
    assert ms == pytest.approx(cost_ms, rel=1e-9)
    k1, k2 = timing.K1, timing.K2
    assert len(calls) == (1 + timing.ROUNDS) * (k1 + k2)
    # iteration k of a run sees (base + k) & 3
    assert [int(c[0]) for c in calls[:k1]] == [k & 3 for k in range(k1)]
    assert [int(c[0]) for c in calls[k1: k1 + k2]] == [
        k & 3 for k in range(k2)]
    line = capsys.readouterr().out.strip()
    assert line.startswith("known-cost stage") and "ms/iter" in line
    assert line.endswith(f"{1e6 / (cost_ms / 1e3) / 1e9:8.2f} Gunit/s")
    assert f"{ms:8.3f} ms/iter" in line


TOOLS = {
    "prof_scan_parts": (prof_scan_parts.main, [], [
        "1a gather", "1b gather", "1c gather", "2  PV build",
        "3a words strided", "3b words packed", "3c words all-pos",
        "4  torch.nonzero",
        "5a table_gather global (8, 128) [P1]: OK correct=True",
        "5b table_gather global (8, 128) vs torch.take [P2]: OK "
        "correct=True",
        "5g staged geometry 4 KiB: clusters of 1 blocks x 1024 entries "
        "(4128 bytes of shared memory a block)",
        "5g staged geometry 8 KiB: clusters of 1 blocks x 2048 entries",
        "5s table_gather staged 4 KiB (8, 128): OK correct=True",
        "5s table_gather staged 8 KiB (8, 128) [P1]: OK correct=True",
        "5s table_gather staged 929665 entries: refused (ValueError",
        "5c table_gather global 4096 [P3]: OK correct=True",
        "5s table_gather staged 4 KiB 4096: OK correct=True",
        "5s table_gather staged 8 KiB 4096 [P3]: OK correct=True",
        "5c gather 4096 global 8 KiB", "5c gather 4096 staged 8 KiB",
        "5c tab[idx] 4096 8 KiB",
        "5c gather 4096 staged 4 KiB", "5c tab[idx] 4096 4 KiB",
        "5d staged sweep 4096: not measured on the cpu",
        "5c gather 65536 global 8 KiB",
        "# table_gather bit-equal in every check: True"]),
    "prof_scan_rate": (prof_scan_rate.main, [], [
        "A words-only", "B +PV probe", "C +compact", "D1 scan_block",
        "D2 +seed compact: not ported", "D3 +mini_extend_packed",
        "D seeding_scan_mini", "E full w/ packed mini: not ported",
        "# scan+mini device rate:"]),
    "prof_gapped": (prof_gapped.main, [], [
        "alive: K2 64 jobs, rows 16", "dead: K2 64 jobs, rows 16",
        "ms per launch", "Gcells/s"]),
    "prof_gapped --parity": (prof_gapped.main, ["--parity"], [
        "parity: 256/256 jobs exact"]),
    "prof_e2e config1": (prof_e2e.main, ["config1"], [
        "# warm-up", "# run 0:", "# run 1:", "q/s",
        "== gblastn_tpu stage report ==", "device.seeding.pipeline"]),
    "prof_e2e config1w": (prof_e2e.main, ["config1w"], [
        "# warm-up", "# run 1:", "device.seeding.finish"]),
    "prof_e2e config2d": (prof_e2e.main, ["config2d"], [
        "# warm-up", "# run 1:", "device.seeding.finish"]),
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_runs_on_the_cpu_at_a_small_size(tool, capsys):
    main, extra, labels = TOOLS[tool]
    assert main(extra + ["--device", "cpu", "--small"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu (plain PyTorch; no device "
                          "measurement)")
    for label in labels:
        assert label in out, label


@pytest.mark.parametrize("tool", ["prof_scan_parts", "prof_scan_rate",
                                  "prof_gapped", "prof_e2e config1"])
def test_tool_without_a_card_raises(tool):
    """The default device is cuda; without a card each tool raises
    before it measures anything: there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    main, extra, _ = TOOLS[tool]
    with pytest.raises(RuntimeError, match="is_available"):
        main(extra)


def test_prof_launch_needs_a_card(capsys):
    """prof_launch times kernels on the card only: without one it exits 2
    with a note and measures nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert prof_launch.main(["--parent", "x"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


def test_prof_gapped_workload_is_checked_and_ordered():
    """prof_gapped.workload's job sets come from check_jobs: the launch
    order is set, longest row budget first, and the ranges were checked
    for the workload's query, subject and rows."""
    from gblastn_tpu_torch.ops.gapped import row_budget

    q, s2, _mat, kw, sets = prof_gapped.workload(torch.device("cpu"),
                                                 small=True, n_sets=2)
    for name in ("alive", "dead"):
        assert len(sets[name]) == 2
        for jobs in sets[name]:
            assert jobs.checked == (q.numel(), s2.numel(), kw["rows"])
            b = row_budget(jobs.m, jobs.n, kw["rows"])[jobs.order.long()]
            assert bool((b[:-1] >= b[1:]).all())


def test_scan_parts_records_give_the_kernels_entry(capsys):
    """prof_scan_parts.profile() returns a record for each shape and mode
    of the table gather, and chip_smoke.py builds its kernels line's
    table_gather entry from them, with every key the line needs."""
    import chip_smoke

    out = prof_scan_parts.profile(["--device", "cpu", "--small"])
    assert out["ok"]
    recs = out["gather"]
    assert sorted(recs) == sorted(f"{s}_{m}" for s in ("p1", "p3", "huge")
                                  for m in ("global", "staged", "staged_pv"))
    assert out["sweep"] == {}                   # measured on the card only
    sz = prof_scan_parts.SMALL
    assert [recs[f"{s}_global"]["n"] for s in ("p1", "p3", "huge")] == [
        1024, sz.gn, sz.huge]
    assert recs["p3_staged"]["table_entries"] == sz.staged
    assert recs["p3_staged_pv"]["table_entries"] == sz.table // 32
    for r in recs.values():
        assert r["ok"] and r["max_abs_err"] == 0 and r["bound_by"] == "bytes"
        assert r["ms"] > 0 and r["plain_ms"] > 0 and r["library_ms"] > 0
        assert r["ms_graph"] is None            # no CUDA graph on the cpu
    entry = chip_smoke.gather_entry(recs, 7)
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in entry, key
    assert (entry["name"], entry["route"]) == ("table_gather", "cuda")
    assert (REPO / entry["source"]).is_file()
    assert entry["launches"] == 7
    assert entry["launches_by_path"] == {"prof_scan_parts": 7}
    assert entry["ms"] == recs["p3_global"]["ms"]
    assert entry["bound_ms_p1_global"] == recs["p1_global"]["bound_ms"]
    assert entry["ms_16mi_staged"] == recs["huge_staged"]["ms"]
    assert entry["bound_ms_p1_staged_pv"] == recs["p1_staged_pv"]["bound_ms"]
    assert "sweep_ms_graph" not in entry
    sweep = {"p3_staged_pv": {"ok": True, "ms": {1: 0.03, 7: 0.009},
                              "rule": 7, "max": 7}}
    assert chip_smoke.gather_entry(recs, 7, sweep)["sweep_ms_graph"] == {
        "p3_staged_pv": {"rule": 7, "max": 7,
                         "ms": {"1": 0.03, "7": 0.009}}}


def test_prof_launch_parent_sources(tmp_path):
    """--parent names a checkout: its K1, K2, G, R and RR sources, or a
    FileNotFoundError that names the first missing one before any
    build."""
    csrc = tmp_path / "gblastn_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    names = {"k1": "ungapped_xdrop.cu", "k2": "gapped_band.cu",
             "g": "approx_gate.cu", "r": "diag_replay.cu",
             "rr": "right_run.cu"}
    for missing in ("ungapped_xdrop.cu", "approx_gate.cu", "diag_replay.cu",
                    "right_run.cu"):
        for f in names.values():
            (csrc / f).write_text("")
        (csrc / missing).unlink()
        with pytest.raises(FileNotFoundError, match=missing):
            prof_launch.parent_sources(tmp_path)
    (csrc / "right_run.cu").write_text("")
    assert prof_launch.parent_sources(tmp_path) == {
        k: csrc / f for k, f in names.items()}
    assert set(prof_launch.parent_sources(REPO)) == set(names)


def test_prof_launch_parent_right_run(tmp_path):
    """--parent's RR wrapper: the right_run of the checkout's
    ops/replay.py, loaded as a module of its own (on CPU tensors it runs
    that file's plain version), or None where the checkout holds only its
    csrc/."""
    from gblastn_tpu_torch.ops import replay as rp
    from gblastn_tpu_torch.tools.replay_sets import random_run_cases

    assert prof_launch.parent_right_run(tmp_path) is None
    fn = prof_launch.parent_right_run(REPO)
    assert fn is not rp.right_run and fn.__module__ == "_parent_replay"
    for _label, args, kw in random_run_cases("cpu", n=512):
        assert torch.equal(fn(*args, **kw), rp.right_run(*args, **kw))


def test_batch_cases_replay_saves_what_run_seeding_keeps():
    """On a small blastn batch on the CPU, replay_sets.batch_cases gives
    G and R the search path's inputs: the plain R over them saves exactly
    the seeds that run_seeding returns, after the gate's demotions."""
    import numpy as np

    from gblastn_tpu_torch import FastaRecord, SequenceDB, blastn_options
    from gblastn_tpu_torch.engine.search import setup_batch
    from gblastn_tpu_torch.engine.seeding import run_seeding
    from gblastn_tpu_torch.ops.replay import approx_gate, diag_replay_ref
    from gblastn_tpu_torch.tools.replay_sets import batch_cases
    from gblastn_tpu_torch.tools.workloads import make_genome, sample_reads

    rng = np.random.default_rng(3)
    genome = make_genome(rng, 60_000)
    pairs, _ = sample_reads(rng, genome, 8, 600, "r")
    db = SequenceDB.from_records([FastaRecord("g", "", genome)], title="g")
    b = setup_batch([FastaRecord(n, "", s) for n, s in pairs], db,
                    blastn_options(evalue=1e-5, max_target_seqs=10),
                    torch.device("cpu"))
    g_args, g_kw, r_args, r_kw = batch_cases(b)
    n = g_args[6].numel()
    assert all(a.numel() == n for a in g_args[6:])
    assert g_kw["word_size"] == r_kw["word_size"] == 11
    saved = diag_replay_ref(*r_args, **r_kw).bool()
    init = run_seeding(b.seed_dev, **b.seed_kw)
    assert 0 < int(saved.sum()) == len(init) < n
    rows = approx_gate(*g_args, **g_kw)
    keep = torch.nonzero(saved).squeeze(1)
    assert sorted(rows[3][keep].tolist()) == sorted(init.score.tolist())
    assert sorted(g_args[6][keep].tolist()) == sorted(init.q_off.tolist())


PTXAS_LOG = """== gapped_band.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118gapped_band_kernelEPKhPKaPKiPKxS8_S6_S6_S6_S6_iiiiiPiS9_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118gapped_band_kernelEPKhPKaPKiPKxS8_S6_S6_S6_S6_iiiiiPiS9_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 26496 bytes smem
== ungapped_xdrop.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19k1_kernelEPKhPKaPKiS5_S5_S5_S5_S5_iiiNS_4OutsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19k1_kernelEPKhPKaPKiS5_S5_S5_S5_S5_iiiNS_4OutsE
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 4096 bytes smem
"""


def test_chip_smoke_k1_records():
    """chip_smoke.py reads each kernel's registers and spills from
    ptxas's report, and builds its kernels line's K1 entry, with every
    key the line needs, from compare_k1's records."""
    import chip_smoke

    assert chip_smoke.ptxas_kernels(PTXAS_LOG) == [
        ("gapped_band.cu", "gapped_band_kernel", 96, 0, 0),
        ("ungapped_xdrop.cu", "k1_kernel", 30, 4, 8)]

    def rec(ms):
        return {"err": 0, "ms": ms, "plain_ms": 9.0, "bound_ms": 0.1,
                "bound_by": "operations", "ms_graph": ms / 2}

    entry = chip_smoke.k1_entry(rec(0.4), rec(0.1), rec(0.2), 3,
                                {"config2_cli": 3}, {"k1_kernel": 30})
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in entry, key
    assert (REPO / entry["source"]).is_file()
    assert entry["ms_graph"] == 0.2 and entry["ms_graph_config1"] == 0.05
    assert entry["ms_random"] == 0.2 and entry["registers"] == {
        "k1_kernel": 30}
    assert entry["launches"] == 3 and entry["max_abs_err"] == 0


def test_build_keeps_its_log(tmp_path, monkeypatch):
    """A current library is not rebuilt and its ptxas report is read back
    from the log kept beside it, so chip_smoke.py finds K1's registers on
    a second run too; a library without its log is rebuilt."""
    import chip_smoke
    from gblastn_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("a build was started")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build_log", "")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    lib = tmp_path / "libgblastn_torch_kernels.so"
    lib.write_bytes(b"")
    with pytest.raises(RuntimeError, match="a build was started"):
        _build.build()
    lib.with_suffix(".log").write_text(PTXAS_LOG)
    assert _build.build() == lib
    assert _build.build_log == PTXAS_LOG
    assert [k[1] for k in chip_smoke.ptxas_kernels(_build.build_log)
            if k[0] == "ungapped_xdrop.cu"] == ["k1_kernel"]


def test_build_one_keys_its_library_by_the_source(tmp_path, monkeypatch):
    """A comparison library is named by its source's text: the same name
    from another checkout's source builds anew (the profilers once timed
    one checkout's kernel under another's name), the same text does
    not."""
    from gblastn_tpu_torch.ops import _build

    built = []

    def fake_nvcc(cmd, **kw):
        out = Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(Path(cmd[-1]).read_bytes())
        built.append(cmd[-1])
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", Path)
    a, b = tmp_path / "a" / "right_run.cu", tmp_path / "p" / "right_run.cu"
    for src, text in ((a, "// this tree"), (b, "// the parent")):
        src.parent.mkdir()
        src.write_text(text)
    lib_a = _build.build_one(a, "right_run_parent")
    lib_b = _build.build_one(b, "right_run_parent")
    assert lib_a != lib_b and lib_b.read_text() == "// the parent"
    assert _build.build_one(b, "right_run_parent") == lib_b
    assert built == [str(a), str(b)]


def test_chip_smoke_rr_work():
    """chip_smoke.py's RR bound counts what the walk needs: a step loop in
    the kernel's order (load the words of the next base, compare, stop
    short of the limit or at the limit) over RR's random sets gives the
    plain version's runs, and the words it loads (each once), the subject
    ends it reads and 16 bytes a seed are rr_work's bytes, its compares
    rr_work's compares."""
    import chip_smoke
    from gblastn_tpu_torch.ops.replay import right_run_ref
    from gblastn_tpu_torch.tools.replay_sets import random_run_cases

    for _label, args, kw in random_run_cases("cpu", n=1024):
        word = kw["word_size"]
        run = right_run_ref(*args, **kw)
        qn, sw, ends, q_off, s_off, oid = (t.tolist() for t in args)
        qwords, swords, subs, compares = set(), set(), set(), 0
        for i in range(len(q_off)):
            o = oid[i]
            got = 0
            if 0 <= o < len(ends):
                subs.add(o)
                q, s = q_off[i] + word, s_off[i] + word
                lim = min(word, 8 * len(qn) - q,
                          min(ends[o], 16 * len(sw)) - s)
                while q >= 0 and s >= 0 and got < lim:
                    qp, sp = q + got, s + got
                    qwords.add(qp // 8)
                    swords.add(sp // 16)
                    compares += 1
                    nib = (qn[qp // 8] >> (4 * (7 - qp % 8))) & 15
                    code = (sw[sp // 16] >> (2 * (15 - sp % 16))) & 3
                    if nib != 1 << code:
                        break
                    got += 1
            assert got == int(run[i]), i
        want = 16 * len(q_off) + 8 * (len(qwords) + len(swords) + len(subs))
        assert want < chip_smoke.nbytes(*args)
        assert chip_smoke.rr_work(args, word, run) == (want, compares)


def test_chip_smoke_finish_entry_sorts():
    """The kernels line's approx_gate and diag_replay entries carry
    replay_keys' one-sort and two-sort times from config 2's R record,
    and ptxas' report names R's two kernels apart."""
    import chip_smoke

    def rec(ms, **extra):
        return {"err": 0, "ms": ms, "plain_ms": 2.0, "bound_ms": 0.01,
                "bound_by": "bytes", "ms_graph": ms / 2, **extra}

    r2 = rec(0.03, sort_ms=0.2, sort_two_ms=0.45)
    entry = chip_smoke.finish_entry(
        "diag_replay", chip_smoke.R_SOURCE, chip_smoke.R_REPLACES,
        {"config2": r2, "config1": rec(0.006)}, 3, {"config2_cli": 3},
        {"diag_replay_kernel": 20}, sorts=r2)
    assert entry["sort_ms"] == 0.2 and entry["sort_ms_two_sorts"] == 0.45
    assert entry["ms_config1"] == 0.006 and entry["ms"] == 0.03
    assert "sort_ms" not in chip_smoke.finish_entry(
        "right_run", chip_smoke.RR_SOURCE, chip_smoke.RR_REPLACES,
        {"config1w": rec(0.004)}, 1, {}, {}, main="config1w")
    log = "== diag_replay.cu\n" + "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1"
        f"{len(k)}{k}EPKxPK4int4PKiS6_iiiiPh' for 'sm_90a'\n"
        f"ptxas info    : Used {r} registers\n"
        for k, r in (("diag_replay_kernel", 60),
                     ("diag_replay_two_hit_kernel", 64)))
    assert [k[1:3] for k in chip_smoke.ptxas_kernels(log)] == [
        ("diag_replay_kernel", 60), ("diag_replay_two_hit_kernel", 64)]
    # a namespace hash whose digits read as the length of a longer name
    assert chip_smoke._kernel_name(
        "_ZN45_GLOBAL__N__0a1b2345c7_12_right_run_cu_d3e3b1c816right_run_"
        "kernelEPKxS1_S1_PKiS3_S3_iiiiiPi") == "right_run_kernel"
