"""P1-P3, the table gather: wrapper, staged geometry and plain version.

The port's counterpart of the three Pallas probes of
``tools/prof_scan_parts.py`` (``gk`` :164, ``gk2`` :183, ``gk3`` :203),
which compute one function, ``out = tab[idx]``, from a table held in the
TPU's fast memory. The kernel itself is ``csrc/table_gather.cu``; it has
two modes, and neither ever turns into the other:

- global: the table is read through L2;
- staged: the table is split into equal slices across the blocks of a
  thread-block cluster (1, 2, 4, 8 or 16 blocks), each slice loaded into
  its block's shared memory by TMA bulk copies, and a probe reads the
  owning block's slice through distributed shared memory. A cluster of
  16 holds up to ``MAX_STAGED_ENTRIES`` entries (16 slices of 227 KiB),
  so the 2 MiB PV of LUT width 12 fits. ``staged_geometry`` is the pure
  function that picks the cluster size, the slice and the number of
  clusters; the kernel checks what it is given.

``table_gather_ref`` is the plain PyTorch version, and ``table_gather``
dispatches on where the tensors live: CPU tensors go to the plain
version, CUDA tensors to the kernel (or an exception). There is no
fallback between the two.

Indices must lie in ``[0, tab.numel())``, as in the TPU probe: the kernel
does not clamp them, and the wrapper does not check them (a check would
cost a reduction and a synchronisation per call, more than the gather at
the probe's shapes).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

SMEM_BYTES = 232_448            # 227 KiB of shared memory a block
SMEM_RESERVED = 32              # the mbarrier and the alignment pad
SLICE_MAX_ENTRIES = (SMEM_BYTES - SMEM_RESERVED) // 4       # 58,104
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_STAGED_ENTRIES = CLUSTER_SIZES[-1] * SLICE_MAX_ENTRIES  # 929,664
# Probes a block of the staged grid takes before one more cluster (one more
# copy of the table) pays: blocks of a cluster of one read their own shared
# memory; a larger cluster's read other blocks' (distributed shared
# memory), over ten times fewer a second. From the cluster sweep of
# tools/prof_scan_parts.py (PERF.md section 6).
PROBES_PER_BLOCK_LOCAL = 8192
PROBES_PER_BLOCK_REMOTE = 1024


class Geometry(NamedTuple):
    """A staged launch: ``clusters`` clusters of ``cluster`` blocks, block
    r holding entries ``[r * slice, (r + 1) * slice)``; ``shift`` is
    log2(slice) where a cluster of more than one block has slices of a
    power of two entries, else -1 (the kernel divides, or a cluster of
    one reads its own slice)."""
    cluster: int
    clusters: int
    slice: int
    shift: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a block of the launch takes."""
        return slice_smem_bytes(self.slice)


def slice_smem_bytes(slice_entries: int) -> int:
    return 4 * slice_entries + SMEM_RESERVED


def slice_layout(n_tab: int) -> tuple[int, int, int]:
    """(cluster size C, slice entries, shift) for a staged table of n_tab
    entries: C is the smallest of ``CLUSTER_SIZES`` whose slice fits a
    block. A cluster of one holds the table as it is (rounded up to 4
    entries); a larger one takes slices of a power of two entries where
    that fits (owner = i >> shift), else of ceil(n_tab / C) rounded up to
    4 entries: every slice starts at the table's own alignment.
    ValueError above ``MAX_STAGED_ENTRIES``."""
    if n_tab < 1:
        raise ValueError("a staged table needs at least one entry")
    for c in CLUSTER_SIZES:
        per = -(-n_tab // c)
        if c == 1:
            if per <= SLICE_MAX_ENTRIES:
                return 1, -(-per // 4) * 4, -1
            continue
        p2 = 1 << (per - 1).bit_length()
        if p2 <= SLICE_MAX_ENTRIES:
            return c, p2, p2.bit_length() - 1
        sl = -(-per // 4) * 4
        if sl <= SLICE_MAX_ENTRIES:
            return c, sl, -1
    raise ValueError(
        f"staged table_gather holds at most {MAX_STAGED_ENTRIES} int32 "
        f"entries ({CLUSTER_SIZES[-1]} slices of 227 KiB of shared memory), "
        f"got {n_tab}")


def staged_geometry(n_tab: int, n: int,
                    max_clusters: Callable[[int, int], int],
                    clusters: int | None = None) -> Geometry:
    """The staged launch for n probes into an n_tab-entry table.

    ``max_clusters(cluster, smem_bytes)`` is the card's limit: how many
    clusters of that many blocks, each with that much shared memory, it
    holds at once (``max_active_clusters`` on a card). Every cluster
    copies the whole table, so the grid follows the work: one cluster
    per ``PROBES_PER_BLOCK_LOCAL`` probes a block for a cluster of one,
    per ``PROBES_PER_BLOCK_REMOTE`` for a larger one, at least 1 and at
    most the card's limit.
    ``clusters`` overrides that count (a sweep); it must lie in
    [1, limit]. RuntimeError when the card can place no cluster of the
    size the table needs, ValueError above ``MAX_STAGED_ENTRIES``."""
    c, sl, shift = slice_layout(n_tab)
    smem = slice_smem_bytes(sl)
    limit = max_clusters(c, smem)
    if limit < 1:
        raise RuntimeError(
            f"staged table_gather: the card places no cluster of {c} blocks "
            f"with {smem} bytes of shared memory each (a table of {n_tab} "
            f"entries needs that size)")
    if clusters is None:
        per = c * (PROBES_PER_BLOCK_LOCAL if c == 1
                   else PROBES_PER_BLOCK_REMOTE)
        clusters = min(max(-(-n // per), 1), limit)
    elif not 1 <= clusters <= limit:
        raise ValueError(f"clusters={clusters}: the card holds 1 to {limit} "
                         f"clusters of {c} blocks at once")
    return Geometry(c, clusters, sl, shift)


def table_gather_ref(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``tab[idx]``, with idx's shape."""
    return tab[idx.long()]


_lib_fns = None       # bound once: see _bind


def _bind():
    """(the launch, the occupancy query, the current raw stream of a
    device, whether the current stream captures): the library's entry
    points and PyTorch's own stream queries, looked up once."""
    global _lib_fns
    if _lib_fns is None:
        from gblastn_tpu_torch.ops import _build

        lib = _build.load()
        _lib_fns = (lib.gblastn_table_gather,
                    lib.gblastn_table_gather_clusters,
                    torch._C._cuda_getCurrentRawStream,
                    torch._C._cuda_isCurrentStreamCapturing)
    return _lib_fns


def max_active_clusters(device: int, cluster: int, smem_bytes: int) -> int:
    """Clusters of ``cluster`` staged blocks with ``smem_bytes`` of shared
    memory each that CUDA device ``device`` holds at once
    (cudaOccupancyMaxActiveClusters; the library caches it per device)."""
    m = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _bind()[1](device, cluster, smem_bytes, ctypes.byref(m))
    if rc != 0:
        raise RuntimeError(f"table_gather: cluster occupancy query failed: "
                           f"CUDA error {rc}")
    return m.value


@functools.lru_cache(maxsize=256)
def _card_geometry(device: int, n_tab: int, n: int,
                   clusters: int | None) -> Geometry:
    """staged_geometry on card ``device``, once per shape."""
    return staged_geometry(n_tab, n,
                           functools.partial(max_active_clusters, device),
                           clusters)


def _check_args(tab, idx, staged: bool):
    if tab.dtype != torch.int32 or tab.dim() != 1 or not tab.is_contiguous():
        raise ValueError(f"tab: want a contiguous 1-D int32 tensor, got "
                         f"{tab.dim()}-D {tab.dtype}")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"idx: want a contiguous int32 tensor, got "
                         f"{idx.dtype}")
    n_tab, n = tab.numel(), idx.numel()
    if staged and n_tab > MAX_STAGED_ENTRIES:
        slice_layout(n_tab)             # raises its ValueError
    if n and not n_tab:
        raise ValueError("gather from an empty table")
    if n >= 2**31 or n_tab >= 2**31:
        raise ValueError("too many probes or table entries for one launch")
    if idx.device != tab.device:
        raise ValueError(f"tab on {tab.device}, idx on {idx.device}")


def table_gather(tab: torch.Tensor, idx: torch.Tensor, *,
                 staged: bool = False,
                 clusters: int | None = None) -> torch.Tensor:
    """P1-P3: ``out = tab[idx]`` for an int32[n_tab] table and int32
    indices of any shape (the output has the indices' shape).

    ``staged`` holds the table in a cluster's shared memory
    (``staged_geometry``); it takes at most ``MAX_STAGED_ENTRIES`` entries
    and raises ValueError above that, before any dispatch, and
    RuntimeError on a card that can place no cluster of the size the table
    needs. ``clusters`` sets the staged grid's cluster count (for a
    sweep) instead of the geometry's rule. CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream and
    count it in ``table_gather.launches``. A call made while the stream
    captures a CUDA graph only records the launch: it is counted in
    ``table_gather.captured``, and whoever replays the graph adds it to
    ``launches`` at each replay (``tools.timing.graph_ms`` does)."""
    _check_args(tab, idx, staged)
    dev = tab.device
    if dev.type == "cpu":
        return table_gather_ref(tab, idx)
    if dev.type != "cuda":
        raise ValueError(f"table_gather: no kernel for {dev}")
    out = torch.empty_like(idx)
    n = idx.numel()
    if n == 0:
        return out
    fn, _, raw_stream, capturing = _lib_fns or _bind()
    d = dev.index
    n_tab = tab.numel()
    if staged:
        g = _card_geometry(d, n_tab, n, clusters)
        geo = (1, g.cluster, g.clusters, g.slice, g.shift)
    else:
        geo = (0, 0, 0, 0, 0)
    args = (d, tab.data_ptr(), n_tab, idx.data_ptr(), n, out.data_ptr(),
            *geo, raw_stream(d))
    if d == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(d):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"table_gather launch failed: CUDA error {rc}")
    if capturing():
        table_gather.captured += 1
    else:
        table_gather.launches += 1
    return out


table_gather.launches = 0
table_gather.captured = 0
