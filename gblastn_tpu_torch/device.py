"""The one place the port picks its device.

The counterpart of ``JAX_PLATFORMS`` for the JAX package: the device is
named explicitly (``search(..., device=)``, the CLI's ``-device``) and
resolved here. Asking for ``cuda`` on a machine without a usable card
raises; the port never carries on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for ``"cuda"``, ``"cuda:N"`` or ``"cpu"``; a bare
    ``"cuda"`` resolves to the current card's index.

    Raises RuntimeError when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false, and ValueError for any other
    device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but "
                "torch.cuda.is_available() is false; pass device='cpu' "
                "(CLI: -device cpu) to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(
        f"unsupported device {str(dev)!r} (expected 'cuda' or 'cpu')"
    )
