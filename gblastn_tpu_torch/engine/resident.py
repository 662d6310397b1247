"""Database state held on the device for the whole run.

``resident_from_reference`` takes a ``SequenceDB`` (io/seqdb.py, the
host arrays the search reads) and uploads the port's resident form once:
the 2-bit packed bytes, the derived int8 codes, the validity mask, the
packed 16-base words and the subject bounds. The result is cached on the
db object under ``_torch_resident``, one entry per device.

Coordinates are int64 from the scan to R, so the only bound on a
database's size is the card's memory: before anything is uploaded,
the bytes the resident form needs (``resident_bytes``) and a search's
working memory (``SEARCH_WORK_BYTES``, measured) are held against the
card's free memory. A database that does not fit streams through the
card in blocks instead (engine.stream decides, before this module is
reached; with GBLASTN_TPU_STREAM=0 it raises MemoryError), and
``check_fits`` raises MemoryError naming both numbers for any caller
that uploads a database that does not fit. There is no fallback to the
CPU. The derived arrays are built ``ops.seeding.BUILD_CHUNK`` bases a
step, so the upload's transients stay a few hundred MB whatever the
database's size.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.device import resolve_device
from gblastn_tpu_torch.ops.seeding import (
    BUILD_CHUNK,
    pack_subject_words,
    unpack_2na,
    valid_from_intervals,
)

# bytes a padded base of the resident form: packed 1/4, subject2 1,
# valid 1, subject_w 8/16
BYTES_PER_BASE = 0.25 + 1 + 1 + 0.5
# device memory a search takes beside the resident form: on giant
# (chip_smoke.py, 100 x 1 kb reads against one 3.2 Gbase subject) the
# allocator's peak reserve less the resident bytes was 6.65e9 bytes on
# an H100 (4.93e9 of it handed out), rounded up here; most of it is the
# mini-extension's and the scan's chunks (ops.seeding MINI_CHUNK and
# SCAN_CHUNK), which do not grow with the database (chip_smoke.py
# checks the reserve against this)
SEARCH_WORK_BYTES = 7 << 30


@dataclass
class ResidentDB:
    """Per-database device tensors (one copy per device)."""

    device: torch.device
    packed: torch.Tensor        # uint8[S/4] 2-bit packed, PAD-aligned
    subject2: torch.Tensor      # int8[S] 2-bit codes
    valid: torch.Tensor         # bool[S] real-base mask
    subject_w: torch.Tensor     # int64[S/16] 16-base words
    starts: torch.Tensor        # int64[num_seqs] subject starts
    ends: torch.Tensor          # int64[num_seqs] subject ends
    longest: int                # the longest subject's length, in bases

    @property
    def length(self) -> int:
        return int(self.subject2.shape[0])


def resident_bytes(padded_length: int, num_seqs: int) -> int:
    """Device bytes that ``resident_from_reference`` needs for a database
    of ``padded_length`` bases and ``num_seqs`` subjects: the resident
    arrays, and the largest transient of their chunked build (one chunk's
    stacked codes and its words' int64 widening)."""
    resident = int(padded_length * BYTES_PER_BASE) + 16 * num_seqs
    chunk = min(BUILD_CHUNK, padded_length // 4 + 1)
    return resident + 16 * chunk


def free_bytes(device: torch.device) -> int:
    """Device memory this process can still take on the CUDA ``device``:
    the card's free memory and the blocks PyTorch's allocator holds
    cached but unused."""
    free, _total = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def check_fits(need: int, device: torch.device, *,
               what: str = "the resident database",
               instead: str = "a search streams such a database instead "
                              "(engine.stream)") -> None:
    """MemoryError unless ``need`` bytes (of ``what``) and the search's
    working memory (``SEARCH_WORK_BYTES``) fit in the ``free_bytes`` of
    the CUDA ``device``; the message names both numbers, then
    ``instead``. No check on the CPU: the host's allocator answers for
    itself."""
    if device.type != "cuda":
        return
    free = free_bytes(device)
    if need + SEARCH_WORK_BYTES > free:
        raise MemoryError(
            f"{what} needs {need} bytes of device memory, and a search "
            f"{SEARCH_WORK_BYTES} more, and {device} has {free} free; "
            f"{instead}")


def resident_from_reference(db: SequenceDB,
                            device: str | torch.device) -> ResidentDB:
    """Upload ``db`` to ``device`` (cached on ``db._torch_resident``)."""
    device = resolve_device(device)
    cache = getattr(db, "_torch_resident", None)
    if cache is None:
        cache = {}
        db._torch_resident = cache
    res = cache.get(device)
    if res is not None:
        return res
    check_fits(resident_bytes(db.padded_length, db.num_seqs), device)
    packed = torch.from_numpy(db.packed_padded()).to(device)
    starts = torch.from_numpy(np.asarray(db.starts, np.int64)).to(device)
    ends = starts + torch.from_numpy(
        np.asarray(db.lengths, np.int64)
    ).to(device)
    subject2 = unpack_2na(packed)
    res = ResidentDB(
        device=device,
        packed=packed,
        subject2=subject2,
        valid=valid_from_intervals(subject2.shape[0], starts, ends),
        subject_w=pack_subject_words(packed),
        starts=starts,
        ends=ends,
        longest=int(np.max(db.lengths, initial=1)),
    )
    cache[device] = res
    return res
