"""P1-P3, the table gather: wrapper and plain version.

The port's counterpart of the three Pallas probes of
``tools/prof_scan_parts.py`` (``gk`` :164, ``gk2`` :183, ``gk3`` :203),
which compute one function, ``out = tab[idx]``, from a table held in the
TPU's fast memory. The kernel itself is ``csrc/table_gather.cu`` (one
thread per probe; the table read through L2, or staged in each block's
shared memory); ``table_gather_ref`` is its plain PyTorch version, and
``table_gather`` dispatches on where the tensors live: CPU tensors go to
the plain version, CUDA tensors to the kernel (or an exception). There is
no fallback between the two, and the staged mode never turns into the
global one on its own.

Indices must lie in ``[0, tab.numel())``, as in the TPU probe: the kernel
does not clamp them, and the wrapper does not check them (a check would
cost a reduction and a synchronisation per call, more than the gather at
the probe's shapes).
"""
from __future__ import annotations

import torch

MAX_STAGED_ENTRIES = 232_448 // 4     # 227 KiB of shared memory a block


def table_gather_ref(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``tab[idx]``, with idx's shape."""
    return tab[idx.long()]


def _check_args(tab, idx, staged: bool):
    if staged and tab.numel() > MAX_STAGED_ENTRIES:
        raise ValueError(
            f"staged table_gather holds at most {MAX_STAGED_ENTRIES} "
            f"int32 entries (227 KiB of shared memory a block), got "
            f"{tab.numel()}")
    if tab.dtype != torch.int32 or tab.dim() != 1 or not tab.is_contiguous():
        raise ValueError(f"tab: want a contiguous 1-D int32 tensor, got "
                         f"{tab.dim()}-D {tab.dtype}")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"idx: want a contiguous int32 tensor, got "
                         f"{idx.dtype}")
    if idx.device != tab.device:
        raise ValueError(f"tab on {tab.device}, idx on {idx.device}")
    if idx.numel() and not tab.numel():
        raise ValueError("gather from an empty table")
    if idx.numel() >= 2**31 or tab.numel() >= 2**31:
        raise ValueError("too many probes or table entries for one launch")


def table_gather(tab: torch.Tensor, idx: torch.Tensor, *,
                 staged: bool = False) -> torch.Tensor:
    """P1-P3: ``out = tab[idx]`` for an int32[n_tab] table and int32
    indices of any shape (the output has the indices' shape).

    ``staged`` copies the table into each block's shared memory first;
    it takes at most ``MAX_STAGED_ENTRIES`` entries and raises
    ValueError above that, before any dispatch. CPU tensors run the plain
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
    from gblastn_tpu_torch.ops import _build

    out = torch.empty_like(idx)
    if idx.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gblastn_table_gather(
            tab.data_ptr(), tab.numel(), idx.data_ptr(), idx.numel(),
            out.data_ptr(), int(staged), stream,
        )
    if rc != 0:
        raise RuntimeError(f"table_gather launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        table_gather.captured += 1
    else:
        table_gather.launches += 1
    return out


table_gather.launches = 0
table_gather.captured = 0
