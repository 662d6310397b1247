"""K2's plain version and the port's device gapped filter against the JAX
package: ``banded_gapped_scores_ref`` against the NumPy oracle
``gblastn_tpu.ops.gapped_ref.banded_dp_score`` job by job, the port's
``device_gapped_rejects`` against the JAX package's (its kernel stubbed
by the oracle, as tests/test_gapped_device.py does), and the port's
blastn search with the filter forced on against the filter off and the
JAX package. Everything is integer: comparisons are exact."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import gblastn_tpu.engine.gapped as jeg
import gblastn_tpu.engine.search as jes
import gblastn_tpu.ops.pallas_gapped as jpg
from gblastn_tpu.io.fasta import FastaRecord as JaxRecord
from gblastn_tpu.io.seqdb import SequenceDB as JaxDB
from gblastn_tpu.ops.gapped_ref import banded_dp_score
from gblastn_tpu.params.options import blastn_options as jax_blastn
from gblastn_tpu.params.options import megablast_options as jax_megablast
from gblastn_tpu_torch.engine import gapped as teg
from gblastn_tpu_torch.engine import search as tes
from gblastn_tpu_torch.engine.seeding import run_seeding
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.ops import gapped as og
from gblastn_tpu_torch.params.options import blastn_options, megablast_options
from gblastn_tpu_torch.utils.profiling import slog

# the plain versions run many small ops: on the CPU one thread beats a pool
torch.set_num_threads(1)

BASES = "ACGT"


def _scoring(kind):
    """(port options, JAX options, gap_x_dropoff) of one task's scoring."""
    if kind == "blastn":
        return blastn_options(), jax_blastn(), 33
    return megablast_options(), jax_megablast(), 27


@pytest.mark.parametrize("kind", ["blastn", "megablast"])
def test_device_params_match_jax(kind):
    opts, jopts, gxd = _scoring(kind)
    got = teg.device_gapped_params(opts, gxd)
    want = jeg.device_gapped_params(jopts, gxd)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def _random_jobs(rng, n_seeds):
    """A subject and a query with planted similar stretches (3% mutated;
    a third carry a 70-base insertion, past the band's half width), N
    bases in the query, and seeds on and off the plants, some with empty
    sides (M or N = 0)."""
    S, Q = 30000, 20000
    sub = rng.integers(0, 4, S).astype(np.int8)
    q = rng.integers(0, 4, Q).astype(np.uint8)
    seeds = []
    for k in range(n_seeds):
        if k % 2 == 0:
            L = int(rng.integers(150, 500))
            so = int(rng.integers(1000, S - L - 1000))
            qo = int(rng.integers(1000, Q - L - 1200))
            seg = sub[so: so + L].astype(np.uint8).copy()
            mut = rng.random(L) < 0.03
            seg[mut] = rng.integers(0, 4, int(mut.sum()))
            if k % 3 == 0:
                cut = L // 3
                seg = np.concatenate([seg[:cut], rng.integers(
                    0, 4, 70).astype(np.uint8), seg[cut:]])
            q[qo: qo + len(seg)] = seg
            d = int(rng.integers(0, min(L // 3, 40) + 1))
            seeds.append((qo + d, so + d))
        else:
            seeds.append((int(rng.integers(500, Q - 500)),
                          int(rng.integers(500, S - 500))))
    q[rng.random(Q) < 0.01] = 14                      # N
    qs = np.array([a for a, _ in seeds], np.int64)
    ss = np.array([b for _, b in seeds], np.int64)
    q_lo = np.maximum(qs - rng.integers(0, 900, n_seeds), 0)
    q_hi = np.minimum(qs + rng.integers(0, 900, n_seeds), Q)
    s_lo = np.maximum(ss - rng.integers(0, 900, n_seeds), 0)
    s_hi = np.minimum(ss + rng.integers(0, 900, n_seeds), S)
    q_hi[1::7] = qs[1::7]                             # right N = 0
    s_lo[2::9] = ss[2::9]                             # left M = 0
    return sub, q, qs, ss, q_lo, q_hi, s_lo, s_hi


@pytest.mark.parametrize("kind", ["blastn", "megablast"])
def test_plain_version_matches_oracle(kind):
    """Job by job, score and flags equal the oracle; the job set covers
    both directions, N bases, band-edge and row-budget flags and empty
    jobs."""
    rng = np.random.default_rng(7 if kind == "blastn" else 8)
    n_seeds, rows = 110, 256
    sub, q, qs, ss, q_lo, q_hi, s_lo, s_hi = _random_jobs(rng, n_seeds)
    opts, _jopts, gxd = _scoring(kind)
    matrix, _dbl, go, ge, xd = teg.device_gapped_params(opts, gxd)
    # x: the scoring's own X-drop, and a few large enough to keep row 0
    # alive out to the band edge
    x = np.where(rng.random(n_seeds) < 0.15, 400, xd).astype(np.int32)
    t = torch.from_numpy
    jobs = og.gapped_jobs(t(qs), t(ss), t(q_lo), t(q_hi), t(s_lo),
                          t(s_hi), t(x))
    score, flags = og.banded_gapped_scores(
        t(q), t(sub), t(np.ascontiguousarray(matrix)), jobs, rows=rows,
        gap_open=go, gap_extend=ge,
    )
    assert score.dtype == flags.dtype == torch.int32

    def sf(a, b):
        return int(matrix[b][a])

    want_s, want_f = [], []
    for right in (True, False):
        for i in range(n_seeds):
            if right:
                A, B = sub[ss[i]: s_hi[i]], q[qs[i]: q_hi[i]]
                M, N = s_hi[i] - ss[i], q_hi[i] - qs[i]
            else:
                A, B = sub[s_lo[i]: ss[i]][::-1], q[q_lo[i]: qs[i]][::-1]
                M, N = ss[i] - s_lo[i], qs[i] - q_lo[i]
            r = banded_dp_score(A, B, sf, int(M), int(N), go, ge,
                                int(x[i]), rows)
            want_s.append(r[0])
            want_f.append(r[3])
    np.testing.assert_array_equal(score.numpy(), np.array(want_s))
    np.testing.assert_array_equal(flags.numpy(), np.array(want_f))
    f = flags.numpy()
    assert (f & og.FLAG_EDGE).any() and (f & og.FLAG_ROWS).any()
    assert (f == 0).sum() > n_seeds
    empty = (jobs.m.numpy() <= 0) | (jobs.n.numpy() <= 0)
    assert empty.sum() >= 20 and (score.numpy()[empty] == 0).all()
    assert (score.numpy() > 100).sum() >= 15


def test_scan_reach_within_tpu_steps():
    """The port's reach (band positions the horizontal-gap scan needs)
    never exceeds what the TPU kernel's truncated scan covers: 2^steps
    positions back from _scan_steps, for the batch's X unbucketed."""
    assert og.scan_reach(33, 5, 2, 2) == 23            # config 2
    assert og.scan_reach(54, 0, 5, 2) == 14            # megablast greedy
    assert og.scan_reach(400, 5, 2, 2) == og.W
    assert og.scan_reach(33, 5, 0, 2) == og.W
    for x in range(-5, 700, 7):
        for go in (0, 1, 2, 5, 11):
            for ge in (0, 1, 2, 3, 5):
                for rmax in (-3, 0, 1, 2, 4, 10):
                    g = og.scan_reach(x, go, ge, rmax)
                    assert 1 <= g <= og.W
                    steps = jpg._scan_steps(max(x, go + ge), go, ge, rmax)
                    assert 2 ** steps >= g, (x, go, ge, rmax)


def _long_gap_jobs(rng, n_seeds):
    """Planted stretches with an insertion or a deletion of 1-40 bases
    (near and past the scan's reach at the scorings' X), seeds before the
    gap, X from the scoring's own to 400."""
    S, Q = 20000, 20000
    sub = rng.integers(0, 4, S).astype(np.int8)
    q = rng.integers(0, 4, Q).astype(np.uint8)
    qs, ss = [], []
    for k in range(n_seeds):
        L = int(rng.integers(120, 300))
        so = int(rng.integers(500, S - L - 500))
        qo = int(rng.integers(500, Q - L - 600))
        seg = sub[so: so + L].astype(np.uint8).copy()
        cut, gap = int(rng.integers(20, L // 2)), int(rng.integers(1, 41))
        if k % 2:
            seg = np.concatenate([seg[:cut], rng.integers(0, 4, gap).astype(
                np.uint8), seg[cut:]])
        else:
            seg = np.concatenate([seg[:cut], seg[cut + gap:]])
        q[qo: qo + len(seg)] = seg
        d = int(rng.integers(0, 15))
        qs.append(qo + d)
        ss.append(so + d)
    qs, ss = np.array(qs, np.int64), np.array(ss, np.int64)
    return (sub, q, qs, ss, np.maximum(qs - 400, 0), np.minimum(qs + 400, Q),
            np.maximum(ss - 400, 0), np.minimum(ss + 400, S))


@pytest.mark.parametrize("case", ["oracle", "long_gap"])
@pytest.mark.parametrize("kind", ["blastn", "megablast"])
def test_cut_scan_matches_full_scan(kind, case):
    """The kernel's form of the scan, a window over scan_reach positions
    with u and E not gated, gives the full scan's score and flags on the
    oracle test's jobs and on jobs with long gaps, for X from the
    scoring's own up to 400 (which needs the whole band)."""
    opts, _jopts, gxd = _scoring(kind)
    matrix, _dbl, go, ge, xd = teg.device_gapped_params(opts, gxd)
    if case == "oracle":
        rng = np.random.default_rng(7 if kind == "blastn" else 8)
        n_seeds, rows = 110, 256
        sub, q, qs, ss, q_lo, q_hi, s_lo, s_hi = _random_jobs(rng, n_seeds)
        x = np.where(rng.random(n_seeds) < 0.15, 400, xd)
    else:
        rng = np.random.default_rng(17 if kind == "blastn" else 18)
        n_seeds, rows = 96, 512
        sub, q, qs, ss, q_lo, q_hi, s_lo, s_hi = _long_gap_jobs(rng, n_seeds)
        x = rng.choice([xd, 2 * xd, 100, 400], n_seeds)
    t = torch.from_numpy
    jobs = og.gapped_jobs(t(qs), t(ss), t(q_lo), t(q_hi), t(s_lo),
                          t(s_hi), t(x.astype(np.int32)))
    args = (t(q), t(sub), t(np.ascontiguousarray(matrix)), jobs)
    kw = dict(rows=rows, gap_open=go, gap_extend=ge)
    full = og.banded_gapped_scores_ref(*args, **kw)
    cut = og.banded_gapped_scores_ref(*args, **kw, cut_scan=True)
    assert torch.equal(cut[0], full[0]) and torch.equal(cut[1], full[1])
    assert (full[0] > 60).sum() >= 20


def test_window_max():
    """_window_max against a direct loop, every window length."""
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.integers(-1000, 1000, (og.W, og.W)))
    g = torch.arange(1, og.W + 1)
    got = og._window_max(u, g)
    for a in range(og.W):
        for p in (0, 1, 2, 5, 64, 100, og.W - 1):
            lo = max(p - int(g[a]), 0)
            want = int(u[a, lo:p].max()) if p > lo else og.NEG
            assert int(got[a, p]) == want, (a, p)


def test_job_order_longest_first():
    """job_order is a permutation by row budget min(M, rows, N + 64),
    largest first (empty jobs last), ties in the caller's order, and
    scattering results back by it restores the caller's order exactly."""
    rng = np.random.default_rng(3)
    J, rows = 5000, 512
    m = torch.from_numpy(rng.integers(-5, 2000, J).astype(np.int32))
    n = torch.from_numpy(rng.integers(-5, 2000, J).astype(np.int32))
    n[::13] = 0
    order = og.job_order(m, n, rows)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values,
                       torch.arange(J, dtype=torch.int32))
    budget = torch.where((m > 0) & (n > 0), torch.minimum(
        m.clamp(max=rows), n + 64), 0)
    assert torch.equal(og.row_budget(m, n, rows), budget)
    b = budget[order.long()]
    assert bool((b[:-1] >= b[1:]).all())
    tie = b[:-1] == b[1:]
    assert bool((order[:-1][tie] < order[1:][tie]).all())
    assert int(b[0]) == rows and int(b[-1]) == 0
    # the kernel: slot k runs job order[k] and writes at that index
    result = torch.from_numpy(rng.integers(0, 10**6, J))
    out = torch.empty_like(result)
    out[order.long()] = result[order.long()]
    assert torch.equal(out, result)
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(J, dtype=torch.int32)
    assert torch.equal(order[inv.long()], torch.arange(J, dtype=torch.int32))


def test_check_jobs_sets_order_and_moves_once():
    t = torch.tensor
    jobs = og.gapped_jobs(t([10, 50]), t([100, 300]), t([0, 40]),
                          t([30, 90]), t([90, 200]), t([150, 400]),
                          t([20, 30], dtype=torch.int32))
    checked = og.check_jobs(jobs, 100, 400, 256)
    assert checked.checked == (100, 400, 256)
    assert checked.order.tolist() == [1, 3, 0, 2]
    assert checked.to("cpu") is checked
    assert og._covered(checked, 100, 400, 256)
    assert og._covered(checked, 120, 500, 128)
    assert not og._covered(checked, 99, 400, 256)
    assert not og._covered(checked, 100, 400, 512)
    assert not og._covered(jobs, 100, 400, 256)
    with pytest.raises(ValueError, match="x_drop"):
        og.check_jobs(dataclasses.replace(
            jobs, x=t([20, og.MAX_X], dtype=torch.int32)), 100, 400, 256)


def test_fold_and_job_layout():
    t = torch.tensor
    jobs = og.gapped_jobs(t([10, 50]), t([100, 300]), t([0, 40]),
                          t([30, 90]), t([90, 200]), t([150, 400]),
                          t([20, 30], dtype=torch.int32))
    assert jobs.n_right == 2 and len(jobs) == 4
    assert jobs.a0.tolist() == [100, 300, 100, 300]
    assert jobs.m.tolist() == [50, 100, 10, 100]
    assert jobs.n.tolist() == [20, 40, 10, 10]
    total, flags = og.fold_directions(
        t([5, 7, 11, 13], dtype=torch.int32),
        t([0, 1, 2, 0], dtype=torch.int32), 2)
    assert total.tolist() == [16, 20] and flags.tolist() == [2, 1]


def test_plain_version_counts_cells():
    """The cell count behind K2's bound: band cells with j in [0, N] of
    every row computed, up to the row budget or the group that died."""
    t = torch.tensor
    q = torch.zeros(40, dtype=torch.uint8)
    s = torch.cat([torch.zeros(30, dtype=torch.int8),
                   torch.ones(30, dtype=torch.int8)])
    mat = torch.full((16, 4), -3, dtype=torch.int32)
    mat[torch.arange(4), torch.arange(4)] = 2
    # job 0 walks 20 matching rows with an X-drop that never prunes; job 1
    # walks mismatches only and is dead by the end of its first group
    jobs = og.gapped_jobs(t([0, 0]), t([0, 30]), t([0, 0]), t([10, 10]),
                          t([0, 30]), t([20, 60]),
                          t([10000, 10], dtype=torch.int32))
    *_, cells = og.banded_gapped_scores_ref(q, s, mat, jobs, rows=256,
                                            gap_open=5, gap_extend=2,
                                            return_cells=True)
    assert cells.tolist() == [20 * 11, 8 * 11, 0, 0]


def test_kernel_argument_checks():
    """The kernel's own argument checks (run before a launch) refuse a
    job that would read outside the query or the subject."""
    t = torch.tensor
    q = torch.zeros(100, dtype=torch.uint8)
    s = torch.zeros(200, dtype=torch.int8)
    mat = torch.zeros(64, dtype=torch.int32)

    def jobs(q_seed, s_seed, q_lo, q_hi, s_lo, s_hi):
        return og.gapped_jobs(t([q_seed]), t([s_seed]), t([q_lo]),
                              t([q_hi]), t([s_lo]), t([s_hi]),
                              t([20], dtype=torch.int32))

    og._check_kernel_args(q, s, mat, jobs(50, 100, 0, 100, 0, 200), 256)
    for bad in (jobs(50, 100, 0, 101, 0, 200), jobs(50, 100, -1, 100, 0,
                                                          200),
                jobs(50, 100, 0, 100, 0, 201)):
        with pytest.raises(ValueError, match="outside"):
            og._check_kernel_args(q, s, mat, bad, 256)
    with pytest.raises(ValueError, match="jobs.x"):
        og._check_kernel_args(q, s, mat, dataclasses.replace(
            jobs(50, 100, 0, 100, 0, 200), x=t([20, 20])), 256)
    # a strided view of the matrix is refused, not read as if contiguous
    with pytest.raises(ValueError, match="matrix16"):
        og._check_kernel_args(q, s, mat.reshape(4, 16).t(),
                              jobs(50, 100, 0, 100, 0, 200), 256)
    with pytest.raises(ValueError, match="16 x 4"):
        og._check_kernel_args(q, s, mat.reshape(8, 8),
                              jobs(50, 100, 0, 100, 0, 200), 256)
    # off the CPU the job set must come from check_jobs (a check there
    # would wait on the card), for this query, subject and rows
    meta = [a.to("meta") for a in (q, s, mat)]
    with pytest.raises(ValueError, match="check_jobs"):
        og._check_kernel_args(*meta, jobs(50, 100, 0, 100, 0, 200).to(
            "meta"), 256)
    ok = og.check_jobs(jobs(50, 100, 0, 100, 0, 200), 100, 200, 256)
    og._check_kernel_args(*meta, ok.to("meta"), 256)
    with pytest.raises(ValueError, match="check_jobs"):
        og._check_kernel_args(*meta, ok.to("meta"), 512)
    with pytest.raises(ValueError, match="no kernel for meta"):
        og.banded_gapped_scores(*meta, ok.to("meta"), rows=256,
                                gap_open=5, gap_extend=2)


def _planted_records():
    """tests/test_gapped_device.py's blastn workload: two noisy reads of
    a 20 kb genome (one reverse-complemented), random junk, and 16-base
    islands that pass the ungapped cutoff and miss the gapped one."""
    rng = np.random.default_rng(42)
    genome = "".join(BASES[i] for i in rng.integers(0, 4, 20000))

    def noisy(seg, seed, p=0.05):
        r = np.random.default_rng(seed)
        out = list(seg)
        for k in np.flatnonzero(r.random(len(seg)) < p):
            out[k] = BASES[(BASES.index(out[k]) + 1 + int(r.integers(0, 3)))
                           % 4]
        return "".join(out)

    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}

    def junk(m, s):
        return "".join(BASES[i] for i in np.random.default_rng(s).integers(
            0, 4, m))

    reads = [
        ("q1", noisy(genome[4000:4400], 1)),
        ("q2", "".join(comp[c] for c in reversed(noisy(genome[15000:15300],
                                                         2)))),
        ("q3", junk(300, 7)),
        ("q4", junk(100, 8) + genome[9000:9016] + junk(100, 9)
         + genome[12000:12016] + junk(80, 10)),
    ]
    return genome, reads


def _hsp_rows(res):
    def fields(h):
        return tuple((k, list(v) if k == "edit_script" and v is not None
                      else v) for k, v in vars(h).items())

    return [(q.query_index, lst.oid, lst.best_evalue, fields(h))
            for q in res.queries for lst in q.hsplists for h in lst.hsps]


@pytest.fixture(scope="module")
def planted():
    """The workload through the JAX package once (filter off), with its
    prelim stage's inputs captured, and the port's databases and reads."""
    genome, reads = _planted_records()
    jdb = JaxDB.from_records([JaxRecord("g", "", genome)], title="t")
    captured = {}
    orig = jes.run_gapped_prelim

    def capture(init, qblock, get_subject2, starts, params, **kw):
        captured.update(init=init, qblock=qblock, params=params)
        return orig(init, qblock, get_subject2, starts, params, **kw)

    mp = pytest.MonkeyPatch()
    mp.setenv("GBLASTN_TPU_GAPPED_FILTER", "0")
    mp.setattr(jes, "run_gapped_prelim", capture)
    try:
        want = jes.search([JaxRecord(n, "", s) for n, s in reads], jdb,
                          jax_blastn(evalue=1e-8))
    finally:
        mp.undo()
    db = SequenceDB.from_records([FastaRecord("g", "", genome)], title="t")
    return dict(jdb=jdb, db=db, want=_hsp_rows(want),
                records=[FastaRecord(n, "", s) for n, s in reads],
                **captured)


def _jax_rejects_with_oracle(planted, rows):
    """The JAX package's device_gapped_rejects with its kernel stubbed by
    the oracle (tests/test_gapped_device.py:92-147)."""
    qblock, params, jdb = planted["qblock"], planted["params"], planted[
        "jdb"]
    matrix, dbl, go, ge, xd = jeg.device_gapped_params(
        params.options, params.gap_x_dropoff)
    dgd = jeg.DeviceGappedData(
        query_ops=(), subject_ops=(), matrix16=matrix, rows=rows, dbl=dbl,
        gap_open=go, gap_extend=ge, x_drop=xd, margin=16 * dbl,
        q_len=len(qblock.buffer), s_len=jdb.padded_length)
    qbuf = np.asarray(qblock.buffer)
    sub = jdb.unpacked()

    def stub(operands, matrix16, q_len, s_len, q_seed, s_seed, q_lo, q_hi,
             s_lo, s_hi, x_drop, *, rows, gap_open, gap_extend,
             interpret=False):
        def sf(a, b):
            return int(matrix16[b][a])

        tot = np.zeros(len(q_seed), np.int64)
        fl = np.zeros(len(q_seed), np.int32)
        for i in range(len(q_seed)):
            qs, ss, x = int(q_seed[i]), int(s_seed[i]), int(x_drop[i])
            r = banded_dp_score(sub[ss: s_hi[i]], qbuf[qs: q_hi[i]], sf,
                                int(s_hi[i] - ss), int(q_hi[i] - qs),
                                gap_open, gap_extend, x, rows)
            l_ = banded_dp_score(sub[s_lo[i]: ss][::-1],
                                 qbuf[q_lo[i]: qs][::-1], sf,
                                 int(ss - s_lo[i]), int(qs - q_lo[i]),
                                 gap_open, gap_extend, x, rows)
            tot[i] = r[0] + l_[0]
            fl[i] = r[3] | l_[3]
        return tot, fl

    mp = pytest.MonkeyPatch()
    mp.setattr(jpg, "banded_gapped_scores", stub)
    try:
        return jeg.device_gapped_rejects(
            planted["init"], qblock, jdb.starts, jdb.lengths, params, dgd)
    finally:
        mp.undo()


def test_rejects_match_jax(planted):
    """setup_batch -> run_seeding at word 11 gives the JAX package's
    InitHits field by field; the port's device_gapped_rejects (plain
    version) equals the JAX package's (oracle-stubbed kernel)."""
    db = planted["db"]
    batch = tes.setup_batch(planted["records"], db, blastn_options(
        evalue=1e-8), "cpu")
    assert batch.seed_kw["word_size"] == 11
    init = run_seeding(batch.seed_dev, **batch.seed_kw)
    want_init = planted["init"]
    for f in dataclasses.fields(want_init):
        np.testing.assert_array_equal(
            np.asarray(getattr(init, f.name)),
            np.asarray(getattr(want_init, f.name)), err_msg=f.name)
    rows = 512
    dgd = teg.build_device_gapped(batch.params, batch.query,
                                  batch.seed_dev.resident.subject2, rows)
    got = teg.device_gapped_rejects(init, batch.qblock, db.starts,
                                    db.lengths, batch.params, dgd)
    want = _jax_rejects_with_oracle(planted, rows)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_search_with_filter_matches_off_and_jax(planted, monkeypatch):
    """GBLASTN_TPU_GAPPED_FILTER=1 on the CPU runs the plain K2: the
    results equal the filter-off search and the JAX package's, and the
    filter rejected candidates."""
    opts = blastn_options(evalue=1e-8)
    monkeypatch.setenv("GBLASTN_TPU_GAPPED_FILTER", "0")
    off = _hsp_rows(tes.search(planted["records"], planted["db"], opts,
                               device="cpu"))
    monkeypatch.setenv("GBLASTN_TPU_GAPPED_FILTER", "1")
    before = slog.diagnostics.device_gapped_rejects
    on = _hsp_rows(tes.search(planted["records"], planted["db"], opts,
                              device="cpu"))
    assert slog.diagnostics.device_gapped_rejects > before
    assert len(off) >= 2
    assert on == off == planted["want"]
