"""K1's plain version (gblastn_tpu_torch.ops.ungapped) against the JAX
package's XLA reference ``gblastn_tpu.ops.seeding.ungapped_extend``, run
unbounded (K1 has no window). Integer outputs, compared exactly."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gblastn_tpu.engine.search import device_matrix16
from gblastn_tpu.ops.pallas_ungapped import make_table64 as jax_table64
from gblastn_tpu.ops.seeding import ungapped_extend
from gblastn_tpu_torch.ops.ungapped import (
    QUERY_PACK,
    make_table64,
    pack_query,
    ungapped_extend_window,
    ungapped_extend_window_ref,
)

# the plain versions run many small ops: on the CPU one thread beats a pool
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    """tests/test_pallas_ungapped.py's problem: a 20 kb subject and a
    query of 3 mutated, sentinel-separated copies of it."""
    rng = np.random.default_rng(515)
    S = 20000
    subject = rng.integers(0, 4, S).astype(np.int8)
    parts = [np.full(1, 15, np.uint8)]
    anchors = []
    cursor = 1
    for start, length in [(3000, 800), (9000, 400), (15000, 1200)]:
        seg = subject[start: start + length].astype(np.uint8).copy()
        for p in np.flatnonzero(rng.random(length) < 0.03):
            seg[p] = (seg[p] + 1) % 4
        anchors.append((cursor, start, length))
        parts.append(seg)
        parts.append(np.full(1, 15, np.uint8))
        cursor += length + 1
    return np.concatenate(parts), subject, device_matrix16(1, -2), anchors


def _port(query, subject, mat, q_off, s_off, xd, max_l, max_r):
    t = torch.from_numpy
    return [o.numpy() for o in ungapped_extend_window(
        pack_query(t(query)), t(subject), t(make_table64(mat)),
        t(q_off), t(s_off), t(xd), t(max_l), t(max_r),
    )]


def _jax(query, subject, mat, q_off, s_off, xd, valid_mask=None):
    n = len(q_off)
    if valid_mask is None:
        valid_mask = np.ones(len(subject), bool)
    out = ungapped_extend(
        jnp.asarray(query), jnp.asarray(subject), jnp.asarray(valid_mask),
        jnp.asarray(mat), jnp.asarray(q_off), jnp.asarray(s_off),
        jnp.asarray(np.ones(n, bool)), jnp.asarray(xd), return_bounds=True,
    )
    return [np.asarray(o) for o in out]


def _whole_buffer_budgets(query, subject, q_off, s_off):
    max_l = np.minimum(q_off, s_off).astype(np.int32)
    max_r = np.minimum(len(query) - q_off,
                       len(subject) - s_off).astype(np.int32)
    return max_l, max_r


def test_tables_match_jax():
    for r, p in ((1, -2), (2, -3), (1, -3)):
        m = device_matrix16(r, p)
        np.testing.assert_array_equal(make_table64(m), jax_table64(m))


def test_planted_contexts_match_xla(problem):
    query, subject, mat, anchors = problem
    rng = np.random.default_rng(8)
    q_off, s_off = [], []
    for qc, sc, length in anchors:
        for o in rng.integers(28, length - 28, 30):
            q_off.append(qc + o)
            s_off.append(sc + o)
    q_off = np.array(q_off, np.int32)
    s_off = np.array(s_off, np.int32)
    xd = np.full(len(q_off), 22, np.int32)
    got = _port(query, subject, mat, q_off, s_off, xd,
                *_whole_buffer_budgets(query, subject, q_off, s_off))
    want = _jax(query, subject, mat, q_off, s_off, xd)
    for k, name in enumerate(["q_start", "s_start", "length", "score"]):
        np.testing.assert_array_equal(got[k], want[k], err_msg=name)
    assert (want[3] > 100).all()        # the walks are real extensions
    assert not (got[4] & 1).any()       # no window, no overrun bit


def test_subject_bound_clamp(problem):
    """Budgets 5 left / 10 right equal a subject that ends there."""
    query, subject, mat, anchors = problem
    qc, sc, _ = anchors[0]
    q_off = np.array([qc + 100], np.int32)
    s_off = np.array([sc + 100], np.int32)
    xd = np.array([22], np.int32)
    got = _port(query, subject, mat, q_off, s_off, xd,
                np.array([5], np.int32), np.array([10], np.int32))
    mask = np.zeros(len(subject), bool)
    mask[sc + 95: sc + 110] = True
    want = _jax(query, subject, mat, q_off, s_off, xd, valid_mask=mask)
    for k in range(4):
        np.testing.assert_array_equal(got[k], want[k])
    assert got[2][0] <= 15 and got[3][0] <= 15
    assert got[4][0] == 2 + 4           # both walks ended at the budget


def test_random_ambiguity_codes_and_bounds():
    """Random seeds, query with N/R/Y and sentinels, some seeds next to
    the buffer ends: all outputs, including the bound-stop bits."""
    rng = np.random.default_rng(2024)
    S, Q = 6000, 5000
    subject = rng.integers(0, 4, S).astype(np.int8)
    query = rng.integers(0, 4, Q).astype(np.uint8)
    plants = []
    for k in range(12):                 # planted matches
        so = int(rng.integers(0, S - 300))
        qo = int(rng.integers(0, Q - 300))
        query[qo: qo + 250] = subject[so: so + 250]
        plants.append((qo, so))
    for code, cnt in ((14, 40), (4, 20), (5, 20)):      # N, R, Y
        query[rng.integers(0, Q, cnt)] = code
    query[::617] = 15
    n = 700
    q_off = rng.integers(1, Q - 1, n)
    s_off = rng.integers(1, S - 1, n)
    # matches running into both subject ends, so budgets end walks
    query[1000:1200] = subject[:200]
    query[3000:3200] = subject[S - 200:]
    d = rng.integers(0, 60, 40)
    q_off[:40], s_off[:40] = 1000 + d, d
    q_off[40:80], s_off[40:80] = 3140 + d, S - 60 + d
    # a quarter of the seeds on the planted diagonals
    for i in range(80, 80 + n // 4):
        qo, so = plants[i % len(plants)]
        d = int(rng.integers(0, 250))
        q_off[i], s_off[i] = qo + d, so + d
    q_off, s_off = q_off.astype(np.int32), s_off.astype(np.int32)
    xd = rng.choice([16, 22, 40], n).astype(np.int32)
    max_l, max_r = _whole_buffer_budgets(query, subject, q_off, s_off)
    got = _port(query, subject, device_matrix16(1, -2), q_off, s_off, xd,
                max_l, max_r)
    want = _jax(query, subject, device_matrix16(1, -2), q_off, s_off, xd)
    for k in range(4):
        np.testing.assert_array_equal(got[k], want[k])
    # bound bits: the XLA reference reports a zero budget as no bound
    # stop; the kernel (like the Pallas kernel) reports it as one
    np.testing.assert_array_equal(
        (got[4] >> 1) & 1, want[5] | (max_l == 0))
    np.testing.assert_array_equal(
        (got[4] >> 2) & 1, want[6] | (max_r == 0))
    assert want[5].sum() > 0 and want[6].sum() > 0


def test_dispatch_is_by_device():
    """CPU tensors take the plain version; a non-CPU tensor never does."""
    q = torch.from_numpy(QUERY_PACK[np.array([15, 0, 1, 2, 3, 15],
                                            np.uint8)])
    s = torch.tensor([0, 1, 2, 3], dtype=torch.int8)
    t64 = torch.from_numpy(make_table64(device_matrix16(1, -2)))
    seeds = [torch.tensor([v], dtype=torch.int32)
             for v in (2, 1, 10, 1, 3)]
    a = ungapped_extend_window(q, s, t64, *seeds)
    b = ungapped_extend_window_ref(q, s, t64, *seeds)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [int(x) for x in a[:4]] == [1, 0, 4, 4]
    with pytest.raises(ValueError):
        ungapped_extend_window(q.to("meta"), s, t64, *seeds)
