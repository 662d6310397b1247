"""Lowercase query masking (-lcase_masking).

Lowercase letters in the input FASTA mark masked regions
(CBlastInputSourceConfig::SetLowercaseMask; reference
blastinput/blast_args.cpp:1480, blast_input.cpp). Applied like the
other query filters as a soft mask: masked ranges are excluded from
lookup-table indexing only.
"""
from __future__ import annotations

import numpy as np


def lowercase_intervals(sequence: bytes | str) -> list[tuple[int, int]]:
    """Inclusive (start, end) runs of lowercase letters."""
    if isinstance(sequence, str):
        sequence = sequence.encode("ascii")
    arr = np.frombuffer(bytes(sequence), dtype=np.uint8)
    low = (arr >= ord("a")) & (arr <= ord("z"))
    if not low.any():
        return []
    d = np.diff(low.astype(np.int8))
    starts = list(np.flatnonzero(d == 1) + 1)
    ends = list(np.flatnonzero(d == -1))
    if low[0]:
        starts.insert(0, 0)
    if low[-1]:
        ends.append(len(arr) - 1)
    return list(zip(map(int, starts), map(int, ends)))


def query_lcase_masks(qblock, records) -> list[list[tuple[int, int]]]:
    """Per-context masked ranges in concatenated-buffer coordinates
    (plus-strand lowercase runs mirrored onto minus contexts, same
    convention as masking.dust.query_dust_masks)."""
    per_query = [lowercase_intervals(r.sequence) for r in records]
    masks: list[list[tuple[int, int]]] = []
    for ctx in qblock.contexts:
        intervals = per_query[ctx.query_index]
        L = ctx.length
        ctx_masks: list[tuple[int, int]] = []
        for a, b in intervals:
            if ctx.frame >= 0:
                ctx_masks.append((ctx.offset + a, ctx.offset + b))
            else:
                ctx_masks.append(
                    (ctx.offset + L - 1 - b, ctx.offset + L - 1 - a)
                )
        ctx_masks.sort()
        masks.append(ctx_masks)
    return masks
