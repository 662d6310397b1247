"""K1 and K2 on the card against their plain versions, on the same CUDA
tensors.

Needs a CUDA card (skips elsewhere). Imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu_torch.engine.search import device_matrix16
from gblastn_tpu_torch.ops.ungapped import (
    make_table64,
    pack_query,
    ungapped_extend_window,
    ungapped_extend_window_ref,
)


@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(99)
    S, Q, n = 50000, 40000, 8192
    subject = rng.integers(0, 4, S).astype(np.int8)
    query = rng.integers(0, 4, Q).astype(np.uint8)
    for _ in range(50):
        so = int(rng.integers(0, S - 400))
        qo = int(rng.integers(0, Q - 400))
        query[qo: qo + 350] = subject[so: so + 350]
    query[rng.integers(0, Q, 300)] = 14      # N
    query[rng.integers(0, Q, 100)] = 4       # R
    query[::401] = 15                        # sentinels
    q_off = rng.integers(0, Q, n)
    s_off = rng.integers(0, S, n)
    max_l = np.minimum(q_off, s_off)
    max_r = np.minimum(Q - q_off, S - s_off)
    i32 = torch.int32

    def t(a, dt=i32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    args = (
        pack_query(t(query, torch.uint8)), t(subject, torch.int8),
        t(make_table64(device_matrix16(1, -2))), t(q_off), t(s_off),
        t(rng.choice([16, 22], n)), t(max_l), t(max_r),
    )
    before = ungapped_extend_window.launches
    got = ungapped_extend_window(*args)
    want = ungapped_extend_window_ref(*args)
    torch.cuda.synchronize()
    assert ungapped_extend_window.launches == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


@pytest.mark.cuda
def test_gapped_kernel_bit_equal_to_plain_version():
    """K2 against its plain version on a small random job set: both
    scorings, planted stretches with a long insertion (band edge), N in
    the query, a short row budget (FLAG_ROWS) and empty jobs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.engine.gapped import device_gapped_params
    from gblastn_tpu_torch.ops.gapped import (
        banded_gapped_scores,
        banded_gapped_scores_ref,
        gapped_jobs,
    )
    from gblastn_tpu_torch.params.options import (
        blastn_options,
        megablast_options,
    )

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(11)
    S, Q, n = 40000, 30000, 600
    sub = rng.integers(0, 4, S).astype(np.int8)
    q = rng.integers(0, 4, Q).astype(np.uint8)
    qs = rng.integers(600, Q - 600, n)
    ss = rng.integers(600, S - 600, n)
    for k in range(0, n, 2):
        L = 400
        seg = sub[ss[k]: ss[k] + L].astype(np.uint8).copy()
        mut = rng.random(L) < 0.03
        seg[mut] = rng.integers(0, 4, int(mut.sum()))
        if k % 6 == 0:
            seg = np.concatenate([seg[:150], rng.integers(0, 4, 70).astype(
                np.uint8), seg[150:]])
        qs[k] = min(qs[k], Q - len(seg) - 1)
        q[qs[k]: qs[k] + len(seg)] = seg
    q[rng.random(Q) < 0.01] = 14
    q_lo = np.maximum(qs - rng.integers(0, 600, n), 0)
    q_hi = np.minimum(qs + rng.integers(0, 600, n), Q)
    s_lo = np.maximum(ss - rng.integers(0, 600, n), 0)
    s_hi = np.minimum(ss + rng.integers(0, 600, n), S)
    q_hi[1::7] = qs[1::7]
    s_lo[2::9] = ss[2::9]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for opts, gxd in ((blastn_options(), 33), (megablast_options(), 27)):
        mat, _dbl, go, ge, xd = device_gapped_params(opts, gxd)
        x = np.where(rng.random(n) < 0.1, 400, xd).astype(np.int32)
        jobs = gapped_jobs(t(qs), t(ss), t(q_lo), t(q_hi), t(s_lo),
                           t(s_hi), t(x))
        args = (t(q), t(sub), t(mat), jobs)
        kw = dict(rows=256, gap_open=go, gap_extend=ge)
        before = banded_gapped_scores.launches
        got = banded_gapped_scores(*args, **kw)
        want = banded_gapped_scores_ref(*args, **kw)
        torch.cuda.synchronize()
        assert banded_gapped_scores.launches == before + 1
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)
        flags = want[1].cpu().numpy()
        assert (flags & 1).any() and (flags & 2).any()
