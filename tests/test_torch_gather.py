"""The table gather P1-P3 (gblastn_tpu_torch.ops.gather) against the TPU
probes' own check.

tools/prof_scan_parts.py checks each Pallas probe with
``np.array_equal(out, np.asarray(tab)[np.asarray(idx)])`` (:178, :194);
here the plain version and the wrapper on CPU tensors must give exactly
that, and ``jnp.take`` (P2's function), on the reference tool's own
``default_rng(1)`` draws at P1's (8, 128) and P3's (2048, 128) shapes.
Integer outputs, compared exactly."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gblastn_tpu_torch.ops.gather import (
    MAX_STAGED_ENTRIES,
    table_gather,
    table_gather_ref,
)
from gblastn_tpu_torch.tools.prof_scan_parts import (
    FULL,
    HBM_BYTES_PER_S,
    gather_bound_ms,
    reference_draws,
)

TABLE = 4 ** 12           # the reference tool's sizes
N_SCAN = 270_588
S = 4_600_000
GN = 262_144


@pytest.fixture(scope="module")
def draws():
    """The reference tool's draws, in its order (pv, lut_off, packed,
    idx, idx2, tab, gidx, bigidx), written out as at
    tools/prof_scan_parts.py:74-217 (lut_off's sort draws nothing)."""
    rng = np.random.default_rng(1)
    rng.integers(0, 1 << 31, TABLE // 32, np.int32)
    rng.integers(0, 130000, TABLE + 1)
    rng.integers(0, 256, S // 4, np.uint8)
    rng.integers(0, TABLE // 32, N_SCAN, np.int32)
    rng.integers(0, TABLE, N_SCAN, np.int32)
    tab = rng.integers(0, 100, (TABLE // 32,), np.int32)
    gidx = rng.integers(0, TABLE // 32, (8, 128), np.int32)
    bigidx = rng.integers(0, TABLE // 32, (GN // 128, 128), np.int32)
    return {"tab": tab, "gidx": gidx, "bigidx": bigidx}


def test_port_tool_keeps_the_reference_draws(draws):
    assert (FULL.S, FULL.n_scan, FULL.table, FULL.gn) == (S, N_SCAN, TABLE,
                                                          GN)
    d = reference_draws(FULL)
    for key in ("tab", "gidx", "bigidx"):
        assert d[key].dtype == draws[key].dtype
        assert np.array_equal(d[key], draws[key]), key


@pytest.mark.parametrize("staged", [False, True], ids=["global", "staged"])
@pytest.mark.parametrize("key", ["gidx", "bigidx"], ids=["P1", "P3"])
def test_gather_matches_reference_check(draws, key, staged):
    tab, idx = draws["tab"], draws[key]
    if staged:      # the staged mode holds the PV of LUT width 10
        tab, idx = tab[: FULL.staged], idx & (FULL.staged - 1)
    want = tab[idx]
    assert np.array_equal(np.asarray(jnp.take(jnp.asarray(tab),
                                              jnp.asarray(idx))), want)
    t_tab, t_idx = torch.from_numpy(tab), torch.from_numpy(idx)
    ref = table_gather_ref(t_tab, t_idx)
    before = table_gather.launches
    got = table_gather(t_tab, t_idx, staged=staged)
    assert table_gather.launches == before       # the CPU runs no kernel
    for out in (ref, got):
        assert out.dtype == torch.int32 and out.shape == idx.shape
        assert np.array_equal(out.numpy(), want)


def test_staged_refuses_a_table_above_shared_memory():
    assert MAX_STAGED_ENTRIES == 58_112          # 227 KiB of int32
    idx = torch.zeros(8, dtype=torch.int32)
    fits = torch.arange(MAX_STAGED_ENTRIES, dtype=torch.int32)
    assert torch.equal(table_gather(fits, idx + 7, staged=True), idx + 7)
    for n in (MAX_STAGED_ENTRIES + 1, TABLE // 32):
        with pytest.raises(ValueError, match="at most 58112"):
            table_gather(torch.zeros(n, dtype=torch.int32), idx,
                         staged=True)
    # the global mode takes it
    big = torch.arange(TABLE // 32, dtype=torch.int32)
    assert torch.equal(table_gather(big, idx + 5), idx + 5)


@pytest.mark.parametrize("bad", ["int64 table", "int64 index", "2-D table",
                                 "strided index", "empty table"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    tab = torch.arange(64, dtype=torch.int32)
    idx = torch.arange(16, dtype=torch.int32)
    args = {"int64 table": (tab.long(), idx),
            "int64 index": (tab, idx.long()),
            "2-D table": (tab.view(8, 8), idx),
            "strided index": (tab, idx[::2]),
            "empty table": (tab[:0], idx)}[bad]
    with pytest.raises(ValueError):
        table_gather(*args)


def test_gather_bound_charges_the_sectors_the_probes_touch(draws):
    """The bytes bound reads each index once, writes each output once and
    reads each 32-byte sector (8 int32) of the table that the indices
    touch once, never more than the whole table."""
    def ms(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    big = torch.zeros(TABLE // 32, dtype=torch.int32)
    idx = torch.tensor([0, 1, 7, 8, 1000, 1000], dtype=torch.int32)
    # sectors 0, 1 and 125
    assert gather_bound_ms(big, idx) == pytest.approx(ms(8 * 6 + 3 * 32))
    small = torch.zeros(60, dtype=torch.int32)      # 8 sectors, 240 bytes
    every = torch.arange(60, dtype=torch.int32).repeat(4)
    assert gather_bound_ms(small, every) == pytest.approx(
        ms(8 * 240 + 240))
    # P1's 1,024 probes touch at most 1,024 sectors of the 2 MiB table
    p1 = gather_bound_ms(torch.from_numpy(draws["tab"]),
                         torch.from_numpy(draws["gidx"]))
    assert ms(8 * 1024 + 32 * 900) < p1 <= ms(8 * 1024 + 32 * 1024)
