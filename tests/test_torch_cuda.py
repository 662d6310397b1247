"""K1 on the card against its plain version, on the same CUDA tensors.

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
