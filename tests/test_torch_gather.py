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
    SLICE_MAX_ENTRIES,
    Geometry,
    slice_layout,
    slice_smem_bytes,
    staged_geometry,
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


@pytest.mark.parametrize("mode", ["global", "staged", "staged_pv"])
@pytest.mark.parametrize("key", ["gidx", "bigidx"], ids=["P1", "P3"])
def test_gather_matches_reference_check(draws, key, mode):
    tab, idx = draws["tab"], draws[key]
    if mode == "staged":    # the narrow staged table: the PV of width 10
        tab, idx = tab[: FULL.staged], idx & (FULL.staged - 1)
    want = tab[idx]
    assert np.array_equal(np.asarray(jnp.take(jnp.asarray(tab),
                                              jnp.asarray(idx))), want)
    t_tab, t_idx = torch.from_numpy(tab), torch.from_numpy(idx)
    ref = table_gather_ref(t_tab, t_idx)
    before = table_gather.launches
    got = table_gather(t_tab, t_idx, staged=mode != "global")
    assert table_gather.launches == before       # the CPU runs no kernel
    for out in (ref, got):
        assert out.dtype == torch.int32 and out.shape == idx.shape
        assert np.array_equal(out.numpy(), want)


def test_staged_refuses_a_table_above_shared_memory():
    """The staged mode holds up to 16 slices of 227 KiB (less 32 bytes a
    slice for the barrier and the alignment pad): P1-P3's own
    int32[524,288] table is taken, a table one entry or one slice past
    the capacity raises ValueError before any dispatch."""
    assert SLICE_MAX_ENTRIES == (232_448 - 32) // 4 == 58_104
    assert MAX_STAGED_ENTRIES == 16 * SLICE_MAX_ENTRIES == 929_664
    idx = torch.zeros(8, dtype=torch.int32)
    pv = torch.arange(TABLE // 32, dtype=torch.int32)
    assert torch.equal(table_gather(pv, idx + 524_287, staged=True),
                       idx + 524_287)
    fits = torch.arange(MAX_STAGED_ENTRIES, dtype=torch.int32)
    assert torch.equal(table_gather(fits, idx + 7, staged=True), idx + 7)
    for n in (MAX_STAGED_ENTRIES + 1, 16 * 232_448 // 4 + SLICE_MAX_ENTRIES):
        with pytest.raises(ValueError, match="at most 929664"):
            table_gather(torch.zeros(n, dtype=torch.int32), idx,
                         staged=True)
    # the global mode takes it
    big = torch.arange(MAX_STAGED_ENTRIES + 1, dtype=torch.int32)
    assert torch.equal(table_gather(big, idx + 5), idx + 5)


# cudaOccupancyMaxActiveClusters on an H100 SXM (132 SMs) for 1,024-thread
# blocks with 128 KiB or more of shared memory each: one block an SM
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def h100_limit(cluster, smem_bytes):
    assert smem_bytes == slice_smem_bytes((smem_bytes - 32) // 4)
    assert smem_bytes <= 232_448
    return H100_CLUSTERS[cluster]


@pytest.mark.parametrize("n", [1, 1024, 262_144, 16 * 2**20],
                         ids=["1", "1024", "262144", "16Mi"])
@pytest.mark.parametrize("table,want", [
    (32_768, ((1, 32_768, -1), (1, 1, 32, 132))),      # 128 KiB
    (131_072, ((4, 32_768, 15), (1, 1, 30, 30))),      # 512 KiB
    (524_288, ((16, 32_768, 15), (1, 1, 7, 7))),       # 2 MiB, P1-P3's
    (929_664, ((16, 58_104, -1), (1, 1, 7, 7))),       # the capacity
], ids=["128KiB", "512KiB", "2MiB", "capacity"])
def test_staged_geometry(table, want, n):
    """Cluster size: the smallest of 1, 2, 4, 8, 16 whose slice fits a
    block; slices of a power of two entries where they fit (shift); the
    grid: one cluster per 8,192 probes a block for a cluster of one
    (local reads), per 1,024 for a larger one (distributed shared
    memory), within [1, the card's limit]."""
    (cluster, sl, shift), counts = want
    g = staged_geometry(table, n, h100_limit)
    k = [1, 1024, 262_144, 16 * 2**20].index(n)
    assert g == Geometry(cluster, counts[k], sl, shift)
    assert g.cluster * g.slice >= table
    assert g.smem_bytes == 4 * sl + 32 <= 232_448
    assert slice_layout(table) == (cluster, sl, shift)


def test_staged_geometry_limits():
    """Odd sizes keep slices a multiple of 4 entries; the card's limit
    bounds a sweep's cluster count; a card that places no cluster of the
    size a table needs raises RuntimeError naming that size."""
    assert slice_layout(1) == (1, 4, -1)
    assert slice_layout(58_105) == (2, 32_768, 15)
    assert slice_layout(131_073) == (4, 32_772, -1)
    assert slice_layout(600_001) == (16, 37_504, -1)
    assert staged_geometry(524_288, 16, h100_limit, clusters=7).clusters == 7
    for bad in (0, 8):
        with pytest.raises(ValueError, match="1 to 7"):
            staged_geometry(524_288, 16, h100_limit, clusters=bad)
    with pytest.raises(RuntimeError, match="no cluster of 16 blocks"):
        staged_geometry(524_288, 1024, lambda c, smem: 0 if c == 16 else 1)
    with pytest.raises(ValueError, match="at most"):
        slice_layout(MAX_STAGED_ENTRIES + 1)


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
