"""Database state held on the device for the whole run.

``resident_from_reference`` takes a ``SequenceDB`` (io/seqdb.py, the
host arrays the search reads) and uploads the port's resident form once:
the 2-bit packed bytes, the derived int8 codes, the validity mask, the
packed 16-base words and the subject bounds. The result is cached on the
db object under ``_torch_resident``, one entry per device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.device import resolve_device
from gblastn_tpu_torch.ops.seeding import (
    pack_subject_words,
    unpack_2na,
    valid_from_intervals,
)

# int32 scan coordinates (the JAX package's resident bound,
# gblastn_tpu/engine/search.py:521)
MAX_RESIDENT_BASES = (1 << 31) - (1 << 20)


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
    if db.padded_length >= MAX_RESIDENT_BASES:
        raise NotImplementedError(
            f"database of {db.padded_length} padded bases: the port's "
            "resident tier holds < 2^31 - 2^20 bases (int32 scan "
            "coordinates); larger databases are ROADMAP Queue 1 item 13"
        )
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
