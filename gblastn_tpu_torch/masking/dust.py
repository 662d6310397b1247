"""Symmetric DUST low-complexity masker (Morgulis et al. 2006).

Host-side reimplementation of CSymDustMasker (reference:
NCBI c++/src/algo/dustmask/symdust.cpp). The algorithm keeps
a <= (window-2)-triplet sliding window with running triplet counts over
the whole window (c_w/r_w) and over a bounded-multiplicity suffix
(c_v/r_v, bounded by low_k = level/5), emits "perfect" (maximal-scoring)
subwindows, and merges intervals closer than ``linker``.

Intervals are returned as inclusive (start, end) base coordinates,
matching the reference's TMaskedInterval convention (bounds second =
stop_+1 = last base of the newest triplet).

blastn applies DUST to queries by default with (level 20, window 64,
linker 1) as a soft mask: masked ranges are excluded from lookup-table
indexing only (mask-at-hash), extensions still see the real bases
(reference: src/algo/blast/api/dust_filter.cpp, blast_filter.c).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from gblastn_tpu_torch.io.encoding import BLASTNA_TO_NCBI4NA

DEFAULT_LEVEL = 20
DEFAULT_WINDOW = 64
DEFAULT_LINKER = 1

TRIPLET_MASK = 0x3F

# BLASTNA -> deterministic 2-bit code: lowest set base bit of the 4na
# representation (A for N), the stand-in for CSeqVector's 2na coercion.
_BLASTNA_TO_2BIT = np.zeros(16, dtype=np.uint8)
for _i in range(16):
    _na4 = int(BLASTNA_TO_NCBI4NA[_i]) or 1
    _BLASTNA_TO_2BIT[_i] = (_na4 & -_na4).bit_length() - 1


class _Triplets:
    """The reference's `triplets` window (symdust.cpp:40-165)."""

    def __init__(self, window: int, low_k: int, perfect_list: list,
                 thresholds: list[int]):
        self.start = 0
        self.stop = 0
        self.max_size = window - 2
        self.low_k = low_k
        self.L = 0
        self.P = perfect_list   # list of [first, second, score, len]
        self.thresholds = thresholds
        self.triplet_list: deque[int] = deque()  # [0] = newest
        self.c_w = [0] * 64
        self.c_v = [0] * 64
        self.r_w = 0
        self.r_v = 0
        self.num_diff = 0

    # add/rem_triplet_info (symdust.hpp:271-292)
    def _add(self, counts, t) -> int:
        # returns the score increment applied (counts[t] before ++ )
        inc = counts[t]
        counts[t] += 1
        return inc

    def _rem(self, counts, t) -> int:
        counts[t] -= 1
        return counts[t]

    def shift_high(self, t: int) -> bool:
        s = self.triplet_list.pop()
        self.r_w -= self._rem(self.c_w, s)
        if self.c_w[s] == 0:
            self.num_diff -= 1
        self.start += 1

        self.triplet_list.appendleft(t)
        if self.c_w[t] == 0:
            self.num_diff += 1
        self.r_w += self._add(self.c_w, t)
        self.stop += 1

        if self.num_diff <= 1:
            self.P.insert(0, [self.start, self.stop + 1, 0, 0])
            return False
        return True

    def shift_window(self, t: int) -> bool:
        if len(self.triplet_list) >= self.max_size:
            if self.num_diff <= 1:
                return self.shift_high(t)
            s = self.triplet_list.pop()
            self.r_w -= self._rem(self.c_w, s)
            if self.c_w[s] == 0:
                self.num_diff -= 1
            if self.L == self.start:
                self.L += 1
                self.r_v -= self._rem(self.c_v, s)
            self.start += 1

        self.triplet_list.appendleft(t)
        if self.c_w[t] == 0:
            self.num_diff += 1
        self.r_w += self._add(self.c_w, t)
        self.r_v += self._add(self.c_v, t)

        if self.c_v[t] > self.low_k:
            off = len(self.triplet_list) - (self.L - self.start) - 1
            while True:
                s = self.triplet_list[off]
                self.r_v -= self._rem(self.c_v, s)
                self.L += 1
                off -= 1
                if s == t:
                    break

        self.stop += 1

        if len(self.triplet_list) >= self.max_size and self.num_diff <= 1:
            self.P.clear()
            self.P.insert(0, [self.start, self.stop + 1, 0, 0])
            return False
        return True

    def needs_processing(self) -> bool:
        count = self.stop - self.L
        return (
            count < len(self.triplet_list)
            and 10 * self.r_w > self.thresholds[count]
        )

    def find_perfect(self) -> None:
        count = self.stop - self.L   # suffix length
        counts = list(self.c_v)
        score = self.r_v
        p_idx = 0
        max_perfect_score = 0
        max_len = 0
        pos = self.L - 1
        i = count                    # triplet_list index (skip the suffix)
        n = len(self.triplet_list)
        while i < n:
            t = self.triplet_list[i]
            cnt = counts[t]
            score += self._add(counts, t)
            if cnt > 0 and score * 10 > self.thresholds[count]:
                while p_idx < len(self.P) and pos <= self.P[p_idx][0]:
                    pscore, plen = self.P[p_idx][2], self.P[p_idx][3]
                    if (
                        max_perfect_score == 0
                        or max_len * pscore > max_perfect_score * plen
                    ):
                        max_perfect_score = pscore
                        max_len = plen
                    p_idx += 1
                if (
                    max_perfect_score == 0
                    or score * max_len >= max_perfect_score * count
                ):
                    max_perfect_score = score
                    max_len = count
                    self.P.insert(
                        p_idx, [pos, self.stop + 1, max_perfect_score, count]
                    )
            i += 1
            count += 1
            pos -= 1


def _save_masked_regions(
    res: list[tuple[int, int]], P: list, wstart: int, start: int,
    linker: int,
) -> None:
    """save_masked_regions (symdust.cpp:182-209)."""
    if not P:
        return
    first, second = P[-1][0], P[-1][1]
    if first < wstart:
        b1 = (first + start, second + start)
        if res:
            s = res[-1][1]
            if s + linker >= b1[0]:
                res[-1] = (res[-1][0], max(s, b1[1]))
            else:
                res.append(b1)
        else:
            res.append(b1)
        while P and P[-1][0] < wstart:
            P.pop()


def dust_mask(
    seq: np.ndarray,
    level: int = DEFAULT_LEVEL,
    window: int = DEFAULT_WINDOW,
    linker: int = DEFAULT_LINKER,
    use_native: bool | None = None,
) -> list[tuple[int, int]]:
    """Mask a sequence of BLASTNA codes; returns inclusive base intervals.

    CSymDustMasker::operator() (symdust.cpp:211-280). Runs the native
    C++ port (native/dust.cpp) when available; the Python state machine
    below is the parity fallback.
    """
    if not (2 <= level <= 64):
        level = DEFAULT_LEVEL
    if not (8 <= window <= 64):
        window = DEFAULT_WINDOW
    if not (1 <= linker <= 32):
        linker = DEFAULT_LINKER

    seq2 = _BLASTNA_TO_2BIT[np.asarray(seq, dtype=np.uint8)]

    if use_native is not False:
        from gblastn_tpu_torch.native import get_lib

        lib = get_lib()
        if lib is not None:
            import ctypes

            s = np.ascontiguousarray(seq2)
            cap = max(len(s) // 2 + 16, 64)
            out = np.empty(2 * cap, dtype=np.int64)
            m = lib.gblastn_dust_mask(
                s.ctypes.data, len(s),
                level, window, linker,
                out.ctypes.data, cap,
            )
            if m > cap:  # can't happen (intervals merge), but be safe
                cap = int(m)
                out = np.empty(2 * cap, dtype=np.int64)
                m = lib.gblastn_dust_mask(
                    s.ctypes.data, len(s),
                    level, window, linker,
                    out.ctypes.data, cap,
                )
            return [
                (int(out[2 * i]), int(out[2 * i + 1])) for i in range(m)
            ]

    low_k = level // 5
    thresholds = [1] + [i * level for i in range(1, window - 2)]
    res: list[tuple[int, int]] = []
    if len(seq2) == 0:
        return res
    start = 0
    stop = len(seq2) - 1

    while stop > 2 + start:
        P: list = []
        w = _Triplets(window, low_k, P, thresholds)

        t = (int(seq2[start]) << 2) + int(seq2[start + 1])
        pos = start + w.stop + 2

        done = False
        while not done and pos <= stop:
            _save_masked_regions(res, P, w.start, start, linker)
            t = ((t << 2) & TRIPLET_MASK) + (int(seq2[pos]) & 0x3)
            pos += 1
            if w.shift_window(t):
                if w.needs_processing():
                    w.find_perfect()
            else:
                while pos <= stop:
                    _save_masked_regions(res, P, w.start, start, linker)
                    t = ((t << 2) & TRIPLET_MASK) + (int(seq2[pos]) & 0x3)
                    if w.shift_window(t):
                        done = True
                        break
                    pos += 1

        wstart = w.start
        while P:
            _save_masked_regions(res, P, wstart, start, linker)
            wstart += 1

        if w.start > 0:
            start += w.start
        else:
            break

    return res


def query_dust_masks(
    qblock,
    level: int = DEFAULT_LEVEL,
    window: int = DEFAULT_WINDOW,
    linker: int = DEFAULT_LINKER,
    query_loc: tuple[int, int] | None = None,
) -> list[list[tuple[int, int]]]:
    """Per-context masked ranges in concatenated-buffer coordinates.

    DUST runs on each query's plus strand (Blast_FindDustFilterLoc,
    dust_filter.cpp); intervals are mirrored onto the minus-strand
    context. Returns one list of inclusive (from, to) buffer ranges per
    context, suitable for lut.builder.unmasked_locations.
    """
    # plus-strand context per query, one pass (not a scan per context)
    plus_ctx: dict[int, object] = {}
    for c in qblock.contexts:
        if c.frame >= 0 and c.query_index not in plus_ctx:
            plus_ctx[c.query_index] = c
    per_query: dict[int, list[tuple[int, int]]] = {}
    masks: list[list[tuple[int, int]]] = []
    for ctx in qblock.contexts:
        qi = ctx.query_index
        if qi not in per_query:
            plus = plus_ctx.get(qi, ctx)
            seq = qblock.buffer[plus.offset: plus.offset + plus.length]
            if plus.frame < 0:
                seq = seq[::-1]  # minus-only search: recover plus order
            if query_loc is not None:
                # -query_loc: DUST runs on the restricted range only
                # (the reference filters the range sequence)
                a = min(max(query_loc[0], 0), len(seq))
                b = min(max(query_loc[1], a), len(seq))
                per_query[qi] = [
                    (s + a, e + a)
                    for s, e in dust_mask(seq[a:b], level, window,
                                          linker)
                ]
            else:
                per_query[qi] = dust_mask(seq, level, window, linker)
        intervals = per_query[qi]
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
