"""The comparison that decides ``correct``: the reference against brute
force, the port's CPU path held correct by it at tiny sizes, and the
control and each fault of the timed path held not correct."""
import time

import numpy as np
import pytest

import control
from gblastn_tpu_torch.engine.search import search
from harness import check, data, loop, spec
from reference import align
from tiny import CELLS, tiny

SCORINGS = [
    {"match": 2, "mismatch": -4, "gap_open": 0, "gap_extend": 5},
    {"match": 2, "mismatch": -3, "gap_open": 5, "gap_extend": 2},
]


def _brute(q, s, sc, local):
    """Gotoh by loops: the best local score, or the global end score."""
    go, ge, neg = sc["gap_open"], sc["gap_extend"], -10**9
    n, m = len(q), len(s)
    H = [[0] * (m + 1) for _ in range(n + 1)]
    E = [[neg] * (m + 1) for _ in range(n + 1)]
    F = [[neg] * (m + 1) for _ in range(n + 1)]
    if not local:
        for j in range(1, m + 1):
            H[0][j] = -(go + j * ge)
        for i in range(1, n + 1):
            H[i][0] = -(go + i * ge)
    best = 0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            E[i][j] = max(E[i][j - 1] - ge, H[i][j - 1] - go - ge)
            F[i][j] = max(F[i - 1][j] - ge, H[i - 1][j] - go - ge)
            d = sc["match"] if q[i - 1] == s[j - 1] else sc["mismatch"]
            h = max(H[i - 1][j - 1] + d, E[i][j], F[i][j])
            H[i][j] = max(h, 0) if local else h
            best = max(best, H[i][j])
    return best if local else H[n][m]


@pytest.mark.parametrize("sc", SCORINGS)
def test_reference_against_brute_force(sc):
    rng = np.random.default_rng(11)
    qs, ss = [], []
    for _ in range(25):
        a = rng.integers(0, 4, rng.integers(1, 30)).astype(np.int8)
        b = np.concatenate([rng.integers(0, 4, 3), a[:6], a[9:],
                            rng.integers(0, 4, 2)]).astype(np.int8)
        b[rng.random(len(b)) < 0.1] = rng.integers(0, 4)
        qs.append(a)
        ss.append(b)
    qs.append(np.zeros(0, np.int8))
    ss.append(np.array([1, 2], np.int8))
    assert align.local_scores(qs, ss, sc).tolist() == [
        _brute(q, s, sc, True) for q, s in zip(qs, ss)]
    assert align.global_scores(qs, ss, sc).tolist() == [
        _brute(q, s, sc, False) for q, s in zip(qs, ss)]
    ung = align.ungapped_best(qs, ss, dict(sc, gap_open=10**5))
    assert ung[:, 0].tolist() == align.local_scores(
        qs, ss, dict(sc, gap_open=10**5)).tolist()


def _cell(cell_name, monkeypatch, search_fn=search):
    """A tiny run of the cell on the CPU, judged at the cell's limit."""
    config, traffic = tiny(cell_name, monkeypatch)
    limit = spec.limits(cell_name)["wrong_reads_pct"]
    run, summary = loop.run_cell(config, traffic, limit, 2**31 + 99, 0.5,
                                 0, "cpu", time.perf_counter(),
                                 search_fn=search_fn)
    assert run.batches >= 2
    assert summary["compared"] == min(run.reads, check.SAMPLE)
    return summary


@CELLS
def test_the_ports_cpu_path_is_correct(cell_name, monkeypatch):
    s = _cell(cell_name, monkeypatch)
    assert s["correct"] and s["wrong"] == 0, s["kinds"]


@CELLS
def test_a_screen_mix_is_data_alone_and_correct(cell_name, monkeypatch):
    """Reads planted nowhere (a mix's ``random_share``) need no new code:
    the CPU path is held correct on a mix of 90% random reads."""
    config, traffic = tiny(cell_name, monkeypatch)
    traffic["random_share"] = 0.9
    limit = spec.limits(cell_name)["wrong_reads_pct"]
    run, s = loop.run_cell(config, traffic, limit, 2**31 + 7, 0.5, 0,
                           "cpu", time.perf_counter())
    assert run.batches >= 2
    assert s["correct"] and s["wrong"] == 0, s["kinds"]


def _unplanted(monkeypatch):
    config, traffic = tiny("hg-mb.map", monkeypatch)
    traffic["random_share"] = 1.0
    genome = data.make_genome(config["subjects"], 8, 128)
    reads = data.make_reads(genome, traffic, 8, 6_000, 1)
    return config, genome, reads


def test_a_read_planted_nowhere_is_held_to_its_own_line(monkeypatch):
    config, genome, reads = _unplanted(monkeypatch)
    i = 0
    q = reads.codes(i)
    pos = int(np.flatnonzero(genome.codes(0, 0, 1000) == q[0])[0])
    one_base = align.bit_score_text(align.bit_score(
        align.raw_score(config["scoring"]["match"], config["scoring"]),
        config["karlin"])).strip()

    def line(bits, s0):
        return [check.read_id(i), genome.ids[0], "100.00", "1", "0", "0",
                "1", "1", str(s0), str(s0), "1e-10", bits]

    cases = {"": [], "ok": [line(one_base, pos + 1)],
             "range": [line("99.0", pos + 1)]}
    for want, lines in cases.items():
        got = check.judge(genome, reads, config, [(0, i)],
                          {0: {check.read_id(i): lines}})
        assert got == [want if want != "ok" else ""], (want, got)


@CELLS
def test_the_control_is_not_correct(cell_name, monkeypatch):
    config, traffic = tiny(cell_name, monkeypatch)
    limit = spec.limits(cell_name)["wrong_reads_pct"]
    s = control.reading(config, traffic, limit, 4242, "cpu")
    assert not s["correct"], s


def _half(batch, db, options, device):
    return search(batch[: len(batch) // 2], db, options, device=device)


def _altered(batch, db, options, device):
    res = search(batch, db, options, device=device)
    for q in res.queries:
        for lst in q.hsplists:
            for h in lst.hsps:
                h.s_off += 1
                h.s_end += 1
    return res


def _frozen():
    """A step that returns its state unchanged: every batch gets the
    first batch's results."""
    first = []

    def fn(batch, db, options, device):
        if not first:
            first.append(search(batch, db, options, device=device))
        return first[0]
    return fn


@CELLS
@pytest.mark.parametrize("fault", ["half", "altered", "frozen"])
def test_a_broken_timed_path_is_not_correct(fault, cell_name, monkeypatch):
    fn = {"half": _half, "altered": _altered, "frozen": _frozen()}[fault]
    s = _cell(cell_name, monkeypatch, search_fn=fn)
    assert not s["correct"], s


def test_a_traced_run_keeps_its_spans_apart(monkeypatch):
    """The profiler covers whole batches from the window's second; the
    host's span metrics are read from the batches it left alone."""
    import torch

    config, traffic = tiny("hg-mb.map", monkeypatch)
    monkeypatch.setattr(loop, "TRACE_SECONDS", 0.0)
    monkeypatch.setattr(loop, "_profiler", lambda: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    limit = spec.limits("hg-mb.map")["wrong_reads_pct"]
    run, s = loop.run_cell(config, traffic, limit, 2**31 + 3, 0.5, 1,
                           "cpu", time.perf_counter())
    assert s["correct"], s["kinds"]
    assert run.batches >= 2 and run.traced_batches == 1
    assert run.span_batches == run.batches - 1
    assert run.trace is not None and 0 < run.trace["window_s"]
    assert run.trace["window_s"] < sum(run.batch_s)
    assert spec.metric_reader("traceback_ms")(run) > 0


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu(cuda_device):
    rng = np.random.default_rng(5)
    qs = [rng.integers(0, 4, n).astype(np.int8) for n in (50, 300, 1500)]
    ss = [np.concatenate([rng.integers(0, 4, 20), q,
                          rng.integers(0, 4, 9)]).astype(np.int8)
          for q in qs]
    for sc in SCORINGS:
        for fn in (align.local_scores, align.global_scores,
                   align.ungapped_best):
            assert np.array_equal(fn(qs, ss, sc, "cpu"),
                                  fn(qs, ss, sc, cuda_device))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
