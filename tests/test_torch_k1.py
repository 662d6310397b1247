"""K1's redesign on the CPU (gblastn_tpu_torch.ops.ungapped): the
shared-memory score table, the plain walk held to a step-by-step loop on
the edge cases of the kernel's groups of 8 steps, the range checks of
the plain path and of the kernel's flags, and the lockstep lane-step
model. A few seconds in all; no JAX."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu_torch.engine.search import device_matrix16
from gblastn_tpu_torch.ops.ungapped import (
    FLAG_RANGE,
    NEG_BIG,
    QUERY_PACK,
    X_LIMIT,
    _scores,
    _walk_ref,
    check_flags,
    lockstep_lane_steps,
    make_table64,
    pack_query,
    score_table,
    ungapped_extend_window,
)

# the plain versions run many small ops: on the CPU one thread beats a pool
torch.set_num_threads(1)

A, C, SENT = 0, 1, 15          # BLASTNA codes: match, mismatch vs A; sentinel
T64 = torch.from_numpy(make_table64(device_matrix16(1, -2)))


def test_score_table_is_the_closed_form():
    """The 1024 entries equal _scores for all 256 x 4 (packed query
    byte, subject code) pairs, table64's 64 BLASTNA x 2na entries through
    the query packing, and clamp a subject code outside 0..3 as the
    closed form does."""
    for r, p in ((1, -2), (2, -3), (1, -3)):
        t64 = make_table64(device_matrix16(r, p))
        tab = score_table(torch.from_numpy(t64))
        assert tab.dtype == torch.int32 and tab.numel() == 1024
        c = [int(v) for v in t64[64:70]]
        qb = torch.arange(256).repeat_interleave(4)
        sc = torch.arange(4).repeat(256)
        assert torch.equal(tab.long(), _scores(qb, sc, c).long())
        for q in range(16):
            for s in range(4):
                assert int(tab[int(QUERY_PACK[q]) * 4 + s]) == t64[q * 4 + s]
        odd = torch.tensor([-5, -1, 4, 100])
        want = _scores(torch.full((4,), int(QUERY_PACK[2])), odd, c)
        assert torch.equal(want, tab[int(QUERY_PACK[2]) * 4
                                     + odd.clamp(0, 3)].to(want.dtype))
    assert int(score_table(T64)[0]) == NEG_BIG      # the sentinel byte 0


def _problem(query, subject, q_off, s_off, x, max_l, max_r):
    t = torch.from_numpy
    i32 = np.int32
    return (pack_query(t(np.asarray(query, np.uint8))),
            t(np.asarray(subject, np.int8)), T64,
            t(np.asarray(q_off, i32)), t(np.asarray(s_off, i32)),
            t(np.asarray(x, i32)), t(np.asarray(max_l, i32)),
            t(np.asarray(max_r, i32)))


def _right_walk(pattern, x, budget=None, lead=8):
    """One seed whose right walk reads ``pattern`` against a subject of
    A; the left walk reads ``lead`` matches."""
    q = [A] * lead + list(pattern) + [SENT]
    sub = [A] * len(q)
    mr = len(pattern) if budget is None else budget
    return _problem(q, sub, [lead], [lead], [x], [lead], [mr])


def _cases():
    """name -> (problem, check on the plain walk's right (best, pos,
    stop)): the check proves the case is what its name says. The kernel
    takes 8 steps a group and redoes a group only where a walk ends."""
    M, X = A, C
    rng = np.random.default_rng(7)
    cases = {
        # drop at step 64 (a group's last step), then at step 65 (the next
        # group's first step): 62 matches, then mismatches
        "drop at a group's last step": (
            _right_walk([M] * 62 + [X] * 10, x=3),
            lambda b, p, s: s == 64),
        "drop at the next group's first step": (
            _right_walk([M] * 62 + [X] * 10, x=5),
            lambda b, p, s: s == 65),
        # best 10 at step 10, back to 10 at step 73 (a later group): the
        # first kept
        "equal bests in two groups": (
            _right_walk([M] * 10 + [X] * 5 + [M, M, X] * 16 + [M] * 10
                        + [X] * 20, x=12),
            lambda b, p, s: b == 10 and p == 10 and s > 73),
    }
    # the budget ends inside a group (63, 66), on a group's last step
    # (64, 128) and first step (65, 129), all matches: the step past it
    # ends the walk
    for budget in (63, 64, 65, 66, 128, 129):
        cases[f"budget {budget}"] = (
            _right_walk([M] * 140, x=10, budget=budget),
            lambda b, p, s, k=budget: b == k and p == k and s == k + 1)
    # zero budgets and x = 0 on random seeds, a query of planted matches
    S, Q, n = 4000, 3000, 300
    sub = rng.integers(0, 4, S)
    q = rng.integers(0, 4, Q)
    for _ in range(8):
        so, qo = int(rng.integers(0, S - 300)), int(rng.integers(0, Q - 300))
        q[qo: qo + 250] = sub[so: so + 250]
    q[rng.integers(0, Q, 30)] = 14
    qo = rng.integers(0, Q, n)
    so = rng.integers(0, S, n)
    ml = np.minimum(qo, so)
    mr = np.minimum(Q - qo, S - so)
    z = np.zeros(n, np.int32)
    cases["max_l = max_r = 0"] = (
        _problem(q, sub, qo, so, rng.choice([0, 16], n), z, z),
        lambda b, p, s: (s == 1).all() and (b == 0).all())
    cases["x = 0"] = (
        _problem(q, sub, qo, so, z, ml, mr),
        lambda b, p, s: (b > 0).any() and (s > 1).any())
    # 1-base contexts: a sentinel every other byte
    qs = np.full(Q, SENT)
    qs[1::2] = rng.integers(0, 4, Q // 2)
    cases["a sentinel every other byte"] = (
        _problem(qs, sub, qo, so, rng.choice([16, 22], n), ml, mr),
        lambda b, p, s: (s <= 2).all())
    return cases


CASES = _cases()


def _walk_loop(qp, sub, q0, s0, left, budget, x, table):
    """One walk of one seed, a step at a time: s_NuclUngappedExtendExact
    as the module states it. (best, pos, stop)."""
    best = pos = run = j = 0
    while True:
        j += 1
        if j > budget:
            sc = NEG_BIG
        else:
            off = -j if left else j - 1
            sc = table[qp[q0 + off] * 4 + min(max(sub[s0 + off], 0), 3)]
        run += sc
        if run < best - x:
            return best, pos, j
        if run > best:
            best, pos = run, j


@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_walk_equals_a_step_loop(name, left):
    """The plain walk (scored 128 steps at a time) gives the step-by-step
    loop's (best, pos, stop) in each direction on the cases above."""
    args, holds = CASES[name]
    qp, s2, t64, q_off, s_off, x, ml, mr = args
    table = score_table(t64).tolist()
    m = ml if left else mr
    got = _walk_ref(qp, s2, q_off.long(), s_off.long(), left, m.long(),
                    x.long(), score_table(t64).long())
    qpl, sl = qp.tolist(), s2.tolist()
    want = [_walk_loop(qpl, sl, int(q_off[i]), int(s_off[i]), left,
                       int(m[i]), int(x[i]), table)
            for i in range(q_off.numel())]
    assert [tuple(int(v[i]) for v in got)
            for i in range(q_off.numel())] == want, name
    if not left:
        b, p, s = (v.numpy() for v in got)
        if b.size == 1:
            b, p, s = int(b[0]), int(p[0]), int(s[0])
        assert holds(b, p, s), name


@pytest.mark.parametrize("seed", [
    (3, 5, 4, 0), (6, 3, 4, 0),               # left past query / subject
    (10, 2, 0, 3), (2, 8, 0, 3),              # right past query / subject
    (6, 5, -1, 0), (6, 5, 0, -1)])            # negative budgets
def test_plain_path_raises_out_of_range(seed):
    """A seed (q_off, s_off, max_l, max_r) whose budget reaches outside
    the query (12 bytes) or the subject (10 bytes) raises on the CPU
    path; budgets that end on both buffers' edges do not, at any x_drop
    (the kernel's limit on x_drop is the kernel's alone)."""
    q = [SENT] + [A] * 11
    qo, so, ml, mr = seed
    with pytest.raises(ValueError, match="outside"):
        ungapped_extend_window(*_problem(q, [A] * 10, [qo], [so], [16],
                                         [ml], [mr]))
    for x in (16, X_LIMIT - 1, X_LIMIT, 2**30):
        out = ungapped_extend_window(*_problem(q, [A] * 10, [6], [5], [x],
                                               [5], [5]))
        assert [int(o[0]) for o in out] == [1, 0, 10, 10, 2 + 4]


def test_check_flags():
    ok = np.array([0, 2, 4, 6], np.int32)
    check_flags(ok)
    check_flags(torch.from_numpy(ok))
    with pytest.raises(ValueError, match="x_drop"):
        check_flags(np.array([0, FLAG_RANGE, 2], np.int32))


def test_lockstep_lane_steps():
    """32 x the longest left + right of each warp of 32 seeds."""
    steps = torch.zeros(2, 40, dtype=torch.int64)
    steps[0, 3], steps[1, 3] = 5, 7          # warp 0's longest: 12
    steps[1, 35] = 100                       # warp 1 (seeds 32..39)
    assert lockstep_lane_steps(steps) == 32 * (12 + 100)
