"""Greedy gapped nucleotide alignment (Zhang et al. 2000), exact semantics.

Host-side reimplementation of the reference greedy aligner (reference:
NCBI c++/src/algo/blast/core/greedy_align.c — ``BLAST_GreedyAlign``
:385 non-affine, ``BLAST_AffineGreedyAlign`` :755) and its driver
``BLAST_GreedyGappedAlignment`` (blast_gapalign.c:2620), including:

* distance-indexed diagonal walk with per-distance X-drop test;
* per-distance best-score bookkeeping (``max_score[d - xdrop_offset]``);
* traceback reconstruction (non-affine :698 and affine :1191);
* ``s_ReduceGaps`` gap-normalization pass (blast_gapalign.c:2547);
* greedy seed-start-point estimation for score-only calls (:2698-2743).

This is the exact-parity oracle for the engine; the C++ fast path in
``gblastn_tpu/native`` must match it operation for operation (tests compare
the two). Match semantics: a position matches iff query code < 4 and equals
the subject code, so query ambiguity codes always mismatch
(s_FindFirstMismatch, greedy_align.c:318).

Edit scripts use the reference op codes via gblastn_tpu_torch.hits
(OP_SUB/OP_INS/OP_DEL); OP_INS consumes query letters (gap in subject),
OP_DEL consumes subject letters (gap in query).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from gblastn_tpu_torch.hits import OP_DEL, OP_INS, OP_SUB, EditScript

GREEDY_MAX_COST = 10000       # greedy_align.h:50
GREEDY_MAX_COST_FRACTION = 2  # greedy_align.h:47
K_INVALID = -2                # kInvalidOffset
K_INVALID_DIAG = 100000000


@dataclass
class GreedySeed:
    start_q: int = 0
    start_s: int = 0
    match_length: int = 0


@dataclass
class GreedyResult:
    score_or_dist: int            # distance (non-affine) or score (affine)
    seq1_align_len: int
    seq2_align_len: int
    edit_ops: EditScript | None   # prelim block order (see caller)
    seed: GreedySeed


def _prelim_add(ops: EditScript, op: int, num: int) -> None:
    """GapPrelimEditBlockAdd: merge runs of the same op type."""
    if num == 0:
        return
    if ops and ops[-1][0] == op:
        ops[-1] = (op, ops[-1][1] + num)
    else:
        ops.append((op, num))


def _first_mismatch(
    seq1: np.ndarray, seq2: np.ndarray, i1: int, i2: int, reverse: bool
) -> int:
    """s_FindFirstMismatch (greedy_align.c:318): run length of matches.

    Indices at or past the sequence end return 0 -- the role of the
    sentinel bytes flanking the reference's buffers (the diagonal walk
    can legitimately step one past the end; the sentinel mismatches
    immediately).
    """
    if i1 >= len(seq1) or i2 >= len(seq2) or i1 < 0 or i2 < 0:
        return 0
    if reverse:
        a = seq1[: len(seq1) - i1][::-1]
        b = seq2[: len(seq2) - i2][::-1]
    else:
        a = seq1[i1:]
        b = seq2[i2:]
    n = min(len(a), len(b))
    if n == 0:
        return 0
    m = (a[:n] < 4) & (a[:n] == b[:n])
    bad = np.flatnonzero(~m)
    return int(bad[0]) if len(bad) else n


class _Rows:
    """Distance-indexed rows of per-diagonal offsets with explicit bases.

    Mirrors the reference memory pool: row d covers absolute diagonal
    indices [base, base + len); reads outside return kInvalidOffset.
    ``width`` is the number of int32 values per diagonal (1 non-affine,
    3 affine: match/insert/delete offsets).

    Score-only mode passes ``keep`` = the number of trailing rows the
    recurrence can reach back to (2 non-affine, max_penalty+1 affine);
    older rows are dropped to bound memory at O(keep * diag_range), the
    role of the reference's row-reuse (greedy_align.c:658-663, 1169-1175).
    Traceback mode keeps every row (keep=0), as the reference pool does.
    """

    def __init__(self, width: int, keep: int = 0):
        self.width = width
        self.keep = keep
        self.rows: list[np.ndarray] = []
        self.bases: list[int] = []

    def alloc(self, d: int, lo: int, hi: int) -> None:
        """Allocate row d covering diagonals [lo, hi]."""
        while len(self.rows) <= d:
            self.rows.append(None)  # type: ignore[arg-type]
            self.bases.append(0)
        # empty diagonal ranges are legal in the affine walk
        # (greedy_align.c:1148-1151); allocate a zero-size row
        n = max(hi - lo + 1, 0)
        self.rows[d] = np.full(
            (n, self.width) if self.width > 1 else n, K_INVALID, np.int64
        )
        self.bases[d] = lo
        if self.keep and d - self.keep >= 0:
            self.rows[d - self.keep] = None  # type: ignore[assignment]

    def get(self, d: int, k: int, slot: int = 0) -> int:
        if d < 0 or d >= len(self.rows) or self.rows[d] is None:
            return K_INVALID
        i = k - self.bases[d]
        row = self.rows[d]
        if i < 0 or i >= (row.shape[0] if row.ndim else len(row)):
            return K_INVALID
        return int(row[i, slot] if self.width > 1 else row[i])

    def set(self, d: int, k: int, value: int, slot: int = 0) -> None:
        i = k - self.bases[d]
        row = self.rows[d]
        if i < 0 or i >= (row.shape[0] if row.ndim else len(row)):
            # grow the row to cover k (reference never needs this because
            # allocation bounds are conservative; kept for safety)
            lo = min(self.bases[d], k - 2)
            hi = max(self.bases[d] + (row.shape[0] if row.ndim else len(row)),
                     k + 3)
            n = hi - lo
            new = np.full(
                (n, self.width) if self.width > 1 else n, K_INVALID, np.int64
            )
            off = self.bases[d] - lo
            if self.width > 1:
                new[off: off + row.shape[0]] = row
            else:
                new[off: off + len(row)] = row
            self.rows[d] = new
            self.bases[d] = lo
            row = new
            i = k - lo
        if self.width > 1:
            row[i, slot] = value
        else:
            row[i] = value


def greedy_align(
    seq1: np.ndarray,
    seq2: np.ndarray,
    reverse: bool,
    xdrop_threshold: int,
    match_cost: int,
    mismatch_cost: int,
    do_traceback: bool,
) -> GreedyResult:
    """BLAST_GreedyAlign (greedy_align.c:385): non-affine greedy extension.

    Returns the *distance* (mismatches + gap letters) in score_or_dist.
    mismatch_cost is the positive magnitude of the penalty.
    """
    len1, len2 = len(seq1), len(seq2)
    best_dist = 0
    best_diag = 0

    max_dist = min(GREEDY_MAX_COST, len2 // GREEDY_MAX_COST_FRACTION + 1)
    diag_origin = max_dist + 2

    xdrop_offset = (xdrop_threshold + match_cost // 2) // (
        match_cost + mismatch_cost
    ) + 1

    index = _first_mismatch(seq1, seq2, 0, 0, reverse)
    seq1_align_len = seq2_align_len = index
    seq1_index = index
    seed = GreedySeed(0, 0, index)
    longest_match_run = index

    if index == len1 or index == len2:
        ops: EditScript | None = None
        if do_traceback:
            ops = []
            _prelim_add(ops, OP_SUB, index)
        return GreedyResult(0, index, index, ops, seed)

    max_score = np.zeros(max_dist + xdrop_offset + 2, np.int64)
    ms = xdrop_offset  # offset into max_score: max_score[ms + d]

    rows = _Rows(width=1, keep=0 if do_traceback else 3)
    rows.alloc(0, diag_origin - 3, diag_origin + 3)
    rows.set(0, diag_origin, seq1_index)
    max_score[ms + 0] = seq1_index * match_cost
    diag_lower = diag_origin - 1
    diag_upper = diag_origin + 1
    end1_reached = end2_reached = False

    d_final = 0
    for d in range(1, max_dist + 1):
        curr_extent = 0
        curr_seq2_index = 0
        curr_diag = 0
        tmp_diag_lower = diag_lower
        tmp_diag_upper = diag_upper

        # sentinels at the fringes of row d-1
        for kk in (diag_lower - 1, diag_lower, diag_upper, diag_upper + 1):
            rows.set(d - 1, kk, K_INVALID)

        xdrop_score = (
            int(max_score[ms + d - xdrop_offset])
            + (match_cost + mismatch_cost) * d
            - xdrop_threshold
        )
        # C computes match_cost/2 in integer arithmetic before the division
        xdrop_score = int(math.ceil(xdrop_score / (match_cost // 2)))

        rows.alloc(d, tmp_diag_lower - 2, tmp_diag_upper + 2)

        for k in range(tmp_diag_lower, tmp_diag_upper + 1):
            seq2_index = max(rows.get(d - 1, k + 1), rows.get(d - 1, k)) + 1
            seq2_index = max(seq2_index, rows.get(d - 1, k - 1))
            seq1_index = seq2_index + k - diag_origin

            if seq2_index < 0 or seq1_index + seq2_index < xdrop_score:
                if k == diag_lower:
                    diag_lower += 1
                else:
                    rows.set(d, k, K_INVALID)
                continue
            diag_upper = k

            run = _first_mismatch(seq1, seq2, seq1_index, seq2_index, reverse)
            if run > longest_match_run:
                seed = GreedySeed(seq1_index, seq2_index, run)
                longest_match_run = run
            seq1_index += run
            seq2_index += run

            rows.set(d, k, seq2_index)

            if seq1_index + seq2_index > curr_extent:
                curr_extent = seq1_index + seq2_index
                curr_seq2_index = seq2_index
                curr_diag = k

            if seq2_index == len2:
                diag_lower = k + 1
                end2_reached = True
            if seq1_index == len1:
                diag_upper = k - 1
                end1_reached = True

        curr_score = curr_extent * (match_cost // 2) - d * (
            match_cost + mismatch_cost
        )
        if curr_score > max_score[ms + d - 1]:
            max_score[ms + d] = curr_score
            best_dist = d
            best_diag = curr_diag
            seq2_align_len = curr_seq2_index
            seq1_align_len = curr_seq2_index + best_diag - diag_origin
        else:
            max_score[ms + d] = max_score[ms + d - 1]

        d_final = d
        if diag_lower > diag_upper:
            break
        if not end2_reached:
            diag_lower -= 1
        if not end1_reached:
            diag_upper += 1

    if not do_traceback:
        return GreedyResult(
            best_dist, seq1_align_len, seq2_align_len, None, seed
        )

    # traceback (greedy_align.c:698)
    ops = []
    d = best_dist
    seq2_index = seq2_align_len
    diag = best_diag
    while d > 0:
        # s_GetNextNonAffineTback (greedy_align.c:281)
        up_left = rows.get(d - 1, diag - 1)
        up_mid = rows.get(d - 1, diag)
        up_right = rows.get(d - 1, diag + 1)
        if up_left > max(up_mid, up_right):
            new_seq2_index = up_left
            new_diag = diag - 1
        elif up_mid > up_right:
            new_seq2_index = up_mid
            new_diag = diag
        else:
            new_seq2_index = up_right
            new_diag = diag + 1

        if new_diag == diag:
            if seq2_index - new_seq2_index > 0:
                _prelim_add(ops, OP_SUB, seq2_index - new_seq2_index)
        elif new_diag < diag:
            if seq2_index - new_seq2_index > 0:
                _prelim_add(ops, OP_SUB, seq2_index - new_seq2_index)
            _prelim_add(ops, OP_INS, 1)
        else:
            if seq2_index - new_seq2_index - 1 > 0:
                _prelim_add(ops, OP_SUB, seq2_index - new_seq2_index - 1)
            _prelim_add(ops, OP_DEL, 1)
        d -= 1
        diag = new_diag
        seq2_index = new_seq2_index

    _prelim_add(ops, OP_SUB, rows.get(0, diag_origin))
    del d_final
    return GreedyResult(best_dist, seq1_align_len, seq2_align_len, ops, seed)


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def _gdb3(a: int, b: int, c: int) -> tuple[int, int, int, int]:
    """BLAST_Gdb3 (ncbi_math.c:427): divide out the common factor."""
    g = _gcd(a, c) if b == 0 else _gcd(a, _gcd(b, c))
    if g > 1:
        return a // g, b // g, c // g, g
    return a, b, c, 1


def affine_greedy_align_native(
    seq1: np.ndarray,
    seq2: np.ndarray,
    reverse: bool,
    xdrop_threshold: int,
    match_score: int,
    mismatch_score: int,
    gap_open: int,
    gap_extend: int,
    do_traceback: bool,
) -> GreedyResult | None:
    """Dispatch to the C++ aligner (native/greedy.cpp); None if the
    native library is unavailable."""
    from gblastn_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None

    # c_void_p argtypes accept raw int addresses: .ctypes.data skips the
    # per-arg data_as()+cast() pair (measurable at ~50us/call otherwise)
    s1 = np.ascontiguousarray(seq1, dtype=np.uint8)
    s2 = np.ascontiguousarray(seq2, dtype=np.uint8)
    out = np.empty(7, dtype=np.int64)
    max_ops = 256
    while True:
        op_types = np.empty(max_ops, dtype=np.int32)
        op_nums = np.empty(max_ops, dtype=np.int32)
        rc = lib.gblastn_greedy_align(
            s1.ctypes.data, len(s1),
            s2.ctypes.data, len(s2),
            int(reverse), int(xdrop_threshold),
            int(match_score), int(mismatch_score),
            int(gap_open), int(gap_extend),
            int(do_traceback),
            op_types.ctypes.data, op_nums.ctypes.data, max_ops,
            out.ctypes.data,
        )
        if rc == 0:
            break
        max_ops *= 4
        if max_ops > 1 << 24:
            return None
    ops: EditScript | None = None
    if do_traceback:
        n = int(out[6])
        ops = list(zip(op_types[:n].tolist(), op_nums[:n].tolist()))
    return GreedyResult(
        score_or_dist=int(out[0]),
        seq1_align_len=int(out[1]),
        seq2_align_len=int(out[2]),
        edit_ops=ops,
        seed=GreedySeed(int(out[3]), int(out[4]), int(out[5])),
    )


def affine_greedy_align(
    seq1: np.ndarray,
    seq2: np.ndarray,
    reverse: bool,
    xdrop_threshold: int,
    match_score: int,
    mismatch_score: int,
    gap_open: int,
    gap_extend: int,
    do_traceback: bool,
    use_native: bool = True,
) -> GreedyResult:
    """BLAST_AffineGreedyAlign (greedy_align.c:755). mismatch_score is the
    positive magnitude. Returns the (possibly x2-scaled) score."""
    if use_native:
        res = affine_greedy_align_native(
            seq1, seq2, reverse, xdrop_threshold, match_score,
            mismatch_score, gap_open, gap_extend, do_traceback,
        )
        if res is not None:
            return res
    # odd match scores are doubled BEFORE the non-affine dispatch
    # (greedy_align.c:801-815), so the non-affine path always sees an
    # even match cost
    if match_score % 2 == 1:
        match_score *= 2
        mismatch_score *= 2
        xdrop_threshold *= 2
        gap_open *= 2
        gap_extend *= 2
    if gap_open == 0 and gap_extend == 0:
        return greedy_align(
            seq1, seq2, reverse, xdrop_threshold, match_score,
            mismatch_score, do_traceback,
        )

    len1, len2 = len(seq1), len(seq2)
    best_dist = 0
    best_diag = 0

    match_score_half = match_score // 2
    op_cost = match_score + mismatch_score
    g_open = gap_open
    g_extend = gap_extend + match_score_half
    op_cost, g_open, g_extend, common = _gdb3(op_cost, g_open, g_extend)
    gap_open_extend = g_open + g_extend
    max_penalty = max(op_cost, gap_open_extend)

    max_dist = min(GREEDY_MAX_COST, len2 // GREEDY_MAX_COST_FRACTION + 1)
    scaled_max_dist = max_dist * g_extend
    diag_origin = max_dist + 2

    xdrop_offset = (xdrop_threshold + match_score_half) // common + 1

    index = _first_mismatch(seq1, seq2, 0, 0, reverse)
    seq1_align_len = seq2_align_len = index
    seq1_index = index
    seed = GreedySeed(0, 0, index)
    longest_match_run = index

    if index == len1 or index == len2:
        ops: EditScript | None = None
        if do_traceback:
            ops = []
            _prelim_add(ops, OP_SUB, index)
        return GreedyResult(index * match_score, index, index, ops, seed)

    max_score = np.zeros(scaled_max_dist + xdrop_offset + 2, np.int64)
    ms = xdrop_offset

    # diag bounds per distance; index shifted by max_penalty for d < 0
    nbounds = scaled_max_dist + 1 + max_penalty + 2
    diag_lower = np.full(nbounds, K_INVALID_DIAG, np.int64)
    diag_upper = np.full(nbounds, -K_INVALID_DIAG, np.int64)
    db = max_penalty  # bounds index offset: diag_lower[db + d]

    M, I, D = 0, 1, 2  # slots: match_off, insert_off, delete_off
    rows = _Rows(width=3, keep=0 if do_traceback else max_penalty + 2)
    rows.alloc(0, diag_origin - 3, diag_origin + 3)
    rows.set(0, diag_origin, seq1_index, M)
    rows.set(0, diag_origin, K_INVALID, I)
    rows.set(0, diag_origin, K_INVALID, D)
    max_score[ms + 0] = seq1_index * match_score
    diag_lower[db + 0] = diag_origin
    diag_upper[db + 0] = diag_origin

    curr_diag_lower = diag_origin - 1
    curr_diag_upper = diag_origin + 1
    end1_diag = 0
    end2_diag = 0
    num_nonempty_dist = 1
    d = 1

    def in_bounds(dd: int, k: int) -> bool:
        return diag_lower[db + dd] <= k <= diag_upper[db + dd]

    while d <= scaled_max_dist:
        curr_extent = 0
        curr_seq2_index = 0
        curr_diag = 0
        tmp_diag_lower = curr_diag_lower
        tmp_diag_upper = curr_diag_upper

        xdrop_score = (
            int(max_score[ms + d - xdrop_offset]) + common * d
            - xdrop_threshold
        )
        xdrop_score = int(math.ceil(xdrop_score / match_score_half))
        if xdrop_score < 0:
            xdrop_score = 0

        rows.alloc(d, tmp_diag_lower - 2, tmp_diag_upper + 2)

        for k in range(tmp_diag_lower, tmp_diag_upper + 1):
            # gap in seq1 (delete): from diagonal k+1
            seq2_index = K_INVALID
            if in_bounds(d - gap_open_extend, k + 1):
                seq2_index = rows.get(d - gap_open_extend, k + 1, M)
            if (
                in_bounds(d - g_extend, k + 1)
                and seq2_index < rows.get(d - g_extend, k + 1, D)
            ):
                seq2_index = rows.get(d - g_extend, k + 1, D)
            rows.set(
                d, k,
                K_INVALID if seq2_index == K_INVALID else seq2_index + 1, D,
            )

            # gap in seq2 (insert): from diagonal k-1
            seq2_index = K_INVALID
            if in_bounds(d - gap_open_extend, k - 1):
                seq2_index = rows.get(d - gap_open_extend, k - 1, M)
            if (
                in_bounds(d - g_extend, k - 1)
                and seq2_index < rows.get(d - g_extend, k - 1, I)
            ):
                seq2_index = rows.get(d - g_extend, k - 1, I)
            rows.set(d, k, seq2_index, I)

            seq2_index = max(rows.get(d, k, I), rows.get(d, k, D))
            if in_bounds(d - op_cost, k):
                seq2_index = max(
                    seq2_index, rows.get(d - op_cost, k, M) + 1
                )

            seq1_index = seq2_index + k - diag_origin

            if seq2_index < 0 or seq1_index + seq2_index < xdrop_score:
                if k == curr_diag_lower:
                    curr_diag_lower += 1
                else:
                    rows.set(d, k, K_INVALID, M)
                continue
            curr_diag_upper = k

            run = _first_mismatch(seq1, seq2, seq1_index, seq2_index, reverse)
            if run > longest_match_run:
                seed = GreedySeed(seq1_index, seq2_index, run)
                longest_match_run = run
            seq1_index += run
            seq2_index += run

            rows.set(d, k, seq2_index, M)
            if seq1_index + seq2_index > curr_extent:
                curr_extent = seq1_index + seq2_index
                curr_seq2_index = seq2_index
                curr_diag = k

            if seq1_index == len1:
                curr_diag_upper = k
                end1_diag = k - 1
            if seq2_index == len2:
                curr_diag_lower = k
                end2_diag = k + 1

        curr_score = curr_extent * match_score_half - d * common
        if curr_score > max_score[ms + d - 1]:
            max_score[ms + d] = curr_score
            best_dist = d
            best_diag = curr_diag
            seq2_align_len = curr_seq2_index
            seq1_align_len = curr_seq2_index + best_diag - diag_origin
        else:
            max_score[ms + d] = max_score[ms + d - 1]

        if curr_diag_lower <= curr_diag_upper:
            num_nonempty_dist += 1
            diag_lower[db + d] = curr_diag_lower
            diag_upper[db + d] = curr_diag_upper
        else:
            diag_lower[db + d] = K_INVALID_DIAG
            diag_upper[db + d] = -K_INVALID_DIAG

        if diag_lower[db + d - max_penalty] <= diag_upper[db + d - max_penalty]:
            num_nonempty_dist -= 1
        if num_nonempty_dist == 0:
            break

        d += 1
        curr_diag_lower = min(
            diag_lower[db + d - gap_open_extend],
            diag_lower[db + d - g_extend],
        ) - 1
        curr_diag_lower = min(curr_diag_lower, diag_lower[db + d - op_cost])
        if end2_diag > 0:
            curr_diag_lower = max(curr_diag_lower, end2_diag)
        curr_diag_upper = max(
            diag_upper[db + d - gap_open_extend],
            diag_upper[db + d - g_extend],
        ) + 1
        curr_diag_upper = max(curr_diag_upper, diag_upper[db + d - op_cost])
        if end1_diag > 0:
            curr_diag_upper = min(curr_diag_upper, end1_diag)
        curr_diag_lower = int(curr_diag_lower)
        curr_diag_upper = int(curr_diag_upper)

    if do_traceback:
        # affine traceback (greedy_align.c:1191)
        ops = []
        d = best_dist
        seq2_index = seq2_align_len
        diag = best_diag
        state = OP_SUB

        def bound_ok(dd: int, k: int) -> bool:
            return (
                0 <= db + dd < nbounds
                and diag_lower[db + dd] <= k <= diag_upper[db + dd]
            )

        while d > 0:
            if state == OP_SUB:
                # s_GetNextAffineTbackFromMatch (greedy_align.c:153)
                advanced = False
                if bound_ok(d - op_cost, diag):
                    new_seq2_index = rows.get(d - op_cost, diag, M)
                    if new_seq2_index >= max(
                        rows.get(d, diag, I), rows.get(d, diag, D)
                    ):
                        d -= op_cost
                        nxt = OP_SUB
                        advanced = True
                if not advanced:
                    if rows.get(d, diag, I) > rows.get(d, diag, D):
                        new_seq2_index = rows.get(d, diag, I)
                        nxt = OP_INS
                    else:
                        new_seq2_index = rows.get(d, diag, D)
                        nxt = OP_DEL
                _prelim_add(ops, OP_SUB, seq2_index - new_seq2_index)
                seq2_index = new_seq2_index
                state = nxt
            elif state == OP_INS:
                _prelim_add(ops, OP_INS, 1)
                # s_GetNextAffineTbackFromIndel (greedy_align.c:203)
                new_diag = diag - 1
                last_d = d - g_extend
                if bound_ok(last_d, new_diag):
                    new_seq2_index = rows.get(last_d, new_diag, I)
                else:
                    new_seq2_index = K_INVALID
                last_d = d - gap_open_extend
                if (
                    bound_ok(last_d, new_diag)
                    and new_seq2_index < rows.get(last_d, new_diag, M)
                ):
                    d -= gap_open_extend
                    state = OP_SUB
                else:
                    d -= g_extend
                    state = OP_INS
                diag -= 1
            else:  # OP_DEL
                _prelim_add(ops, OP_DEL, 1)
                new_diag = diag + 1
                last_d = d - g_extend
                if bound_ok(last_d, new_diag):
                    new_seq2_index = rows.get(last_d, new_diag, D)
                else:
                    new_seq2_index = K_INVALID
                last_d = d - gap_open_extend
                if (
                    bound_ok(last_d, new_diag)
                    and new_seq2_index < rows.get(last_d, new_diag, M)
                ):
                    d -= gap_open_extend
                    state = OP_SUB
                else:
                    d -= g_extend
                    state = OP_DEL
                diag += 1
                seq2_index -= 1

        _prelim_add(ops, OP_SUB, rows.get(0, diag_origin, M))
        return GreedyResult(
            int(max_score[ms + best_dist]),
            seq1_align_len, seq2_align_len, ops, seed,
        )

    return GreedyResult(
        int(max_score[ms + best_dist]),
        seq1_align_len, seq2_align_len, None, seed,
    )


def _combine_prelim_blocks(
    rev_ops: EditScript, fwd_ops: EditScript
) -> EditScript:
    """Blast_PrelimEditBlockToGapEditScript (blast_gapalign.c:2455):
    rev block is emitted in order; fwd block is reversed; adjacent
    same-type ops at the junction merge."""
    esp: EditScript = list(rev_ops)
    for op, num in reversed(fwd_ops):
        if esp and esp[-1][0] == op:
            esp[-1] = (op, esp[-1][1] + num)
        else:
            esp.append((op, num))
    return esp


def reduce_gaps(
    esp: EditScript, q: np.ndarray, s: np.ndarray, q0: int, s0: int
) -> EditScript:
    """s_ReduceGaps (blast_gapalign.c:2547): normalize gap placement.

    q0/s0 are the alignment start offsets in q/s. Mutates a copy of the
    edit script exactly as the reference does (including its in-place
    num adjustments) and rebuilds dropping zero-length ops.
    """
    ops = [list(x) for x in esp]
    qi, si = q0, s0
    i = 0
    for i in range(len(ops)):
        op, num = ops[i]
        if op == OP_SUB:
            qi += num
            si += num
            continue
        if (
            i > 1
            and ops[i][0] != ops[i - 2][0]
            and ops[i - 2][1] > 0
        ):
            d = ops[i][1] + ops[i - 1][1] + ops[i - 2][1]
            if d == 3:
                ops[i - 2][1] = 0
                ops[i - 1][1] = 2
                ops[i][1] = 0
                if op == OP_INS:
                    qi += 1
                else:
                    si += 1
            elif d < 12:
                # try to merge the two gaps through the short sub run
                nm1 = 0
                nm2 = 0
                dd = min(ops[i][1], ops[i - 2][1])
                qi -= ops[i - 1][1]
                si -= ops[i - 1][1]
                q1, s1 = qi, si
                if op == OP_INS:
                    si -= dd
                else:
                    qi -= dd
                for _ in range(ops[i - 1][1]):
                    if q[q1] == s[s1]:
                        nm1 += 1
                    if q[qi] == s[si]:
                        nm2 += 1
                    q1 += 1
                    s1 += 1
                    qi += 1
                    si += 1
                for _ in range(dd):
                    if q[qi] == s[si]:
                        nm2 += 1
                    qi += 1
                    si += 1
                if nm2 >= nm1 - dd:
                    ops[i - 2][1] -= dd
                    ops[i - 1][1] += dd
                    ops[i][1] -= dd
                else:
                    qi, si = q1, s1
        if ops[i][0] == OP_INS:
            qi += ops[i][1]
        else:
            si += ops[i][1]

    # rebuild (blast_gapalign.c:2607): drop zero-num ops, merging the op
    # that follows a dropped one into the previous kept op.
    out: list[list[int]] = []
    i = 0
    n = len(ops)
    while i < n:
        if ops[i][1] > 0:
            out.append([ops[i][0], ops[i][1]])
        else:
            i += 1
            if i < n and out:
                out[-1][1] += ops[i][1]
        i += 1
    return [(op, num) for op, num in out]


@dataclass
class GappedResult:
    """BlastGapAlignStruct essentials after a greedy gapped extension."""

    q_start: int
    q_end: int
    s_start: int
    s_end: int
    score: int
    q_seed_start: int
    s_seed_start: int
    edit_script: EditScript | None


def greedy_gapped_traceback_native(
    query: np.ndarray,
    subject: np.ndarray,
    gap_x_dropoff: int,
    reward: int,
    penalty: int,
    gap_open: int,
    gap_extend: int,
    q_off: int,
    s_off: int,
) -> GappedResult | None:
    """One fused native call for the traceback extension: both greedy
    directions + prelim-block combine + s_ReduceGaps
    (native/greedy.cpp gblastn_greedy_gapped_traceback); None = use the
    two-call Python driver below."""
    from gblastn_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "gblastn_greedy_gapped_traceback"):
        return None
    qa = np.ascontiguousarray(query, dtype=np.uint8)
    sa = np.ascontiguousarray(subject, dtype=np.uint8)
    out = np.empty(6, dtype=np.int64)
    max_ops = 256
    while True:
        op_types = np.empty(max_ops, dtype=np.int32)
        op_nums = np.empty(max_ops, dtype=np.int32)
        rc = lib.gblastn_greedy_gapped_traceback(
            qa.ctypes.data, len(qa), sa.ctypes.data, len(sa),
            int(gap_x_dropoff), int(reward), int(penalty),
            int(gap_open), int(gap_extend),
            int(q_off), int(s_off),
            op_types.ctypes.data, op_nums.ctypes.data, max_ops,
            out.ctypes.data,
        )
        if rc == 0:
            break
        max_ops *= 4
        if max_ops > 1 << 24:
            return None
    n = int(out[5])
    esp = list(zip(op_types[:n].tolist(), op_nums[:n].tolist()))
    return GappedResult(
        q_start=int(out[1]), q_end=int(out[2]),
        s_start=int(out[3]), s_end=int(out[4]),
        score=int(out[0]),
        q_seed_start=q_off, s_seed_start=s_off,
        edit_script=esp,
    )


def greedy_gapped_alignment(
    query: np.ndarray,
    subject: np.ndarray,
    gap_x_dropoff: int,
    reward: int,
    penalty: int,
    gap_open: int,
    gap_extend: int,
    q_off: int,
    s_off: int,
    do_traceback: bool,
    use_native: bool | None = None,
) -> GappedResult:
    """BLAST_GreedyGappedAlignment (blast_gapalign.c:2620).

    ``penalty`` is negative (as in scoring options); query is BLASTNA,
    subject is either 2-bit codes (prelim) or BLASTNA (traceback).
    """
    if do_traceback and use_native is not False:
        res = greedy_gapped_traceback_native(
            query, subject, gap_x_dropoff, reward, penalty,
            gap_open, gap_extend, q_off, s_off,
        )
        if res is not None:
            return res
    mismatch = -penalty
    fwd = affine_greedy_align(
        query[q_off:], subject[s_off:], False, gap_x_dropoff,
        reward, mismatch, gap_open, gap_extend, do_traceback,
    )
    rev = affine_greedy_align(
        query[:q_off], subject[:s_off], True, gap_x_dropoff,
        reward, mismatch, gap_open, gap_extend, do_traceback,
    )
    score = fwd.score_or_dist + rev.score_or_dist
    q_ext_r, s_ext_r = fwd.seq1_align_len, fwd.seq2_align_len
    q_ext_l, s_ext_l = rev.seq1_align_len, rev.seq2_align_len

    if gap_open == 0 and gap_extend == 0:
        # non-affine: convert distance to score
        score = (
            (q_ext_r + s_ext_r + q_ext_l + s_ext_l) * reward // 2
            - score * (reward - penalty)
        )
    elif reward % 2 == 1:
        score //= 2

    esp: EditScript | None = None
    q_seed_start, s_seed_start = q_off, s_off
    if do_traceback:
        esp = _combine_prelim_blocks(rev.edit_ops or [], fwd.edit_ops or [])
        if esp:
            esp = reduce_gaps(esp, query, subject,
                              q_off - q_ext_l, s_off - s_ext_l)
    else:
        # best start point estimation (blast_gapalign.c:2698)
        q_box_l = q_off - q_ext_l
        s_box_l = s_off - s_ext_l
        q_box_r = q_off + q_ext_r
        s_box_r = s_off + s_ext_r
        q_seed_start_l = q_off - rev.seed.start_q
        s_seed_start_l = s_off - rev.seed.start_s
        q_seed_start_r = q_off + fwd.seed.start_q
        s_seed_start_r = s_off + fwd.seed.start_s
        valid_seed_len_l = 0
        valid_seed_len_r = 0
        if q_seed_start_r < q_box_r and s_seed_start_r < s_box_r:
            valid_seed_len_r = min(
                q_box_r - q_seed_start_r, s_box_r - s_seed_start_r
            )
            valid_seed_len_r = min(
                valid_seed_len_r, fwd.seed.match_length
            ) // 2
        else:
            q_seed_start_r = q_off
            s_seed_start_r = s_off
        if q_seed_start_l > q_box_l and s_seed_start_l > s_box_l:
            valid_seed_len_l = min(
                q_seed_start_l - q_box_l, s_seed_start_l - s_box_l
            )
            valid_seed_len_l = min(
                valid_seed_len_l, rev.seed.match_length
            ) // 2
        else:
            q_seed_start_l = q_off
            s_seed_start_l = s_off
        if valid_seed_len_r > valid_seed_len_l:
            q_seed_start = q_seed_start_r + valid_seed_len_r
            s_seed_start = s_seed_start_r + valid_seed_len_r
        else:
            q_seed_start = q_seed_start_l - valid_seed_len_l
            s_seed_start = s_seed_start_l - valid_seed_len_l

    return GappedResult(
        q_start=q_off - q_ext_l,
        q_end=q_off + q_ext_r,
        s_start=s_off - s_ext_l,
        s_end=s_off + s_ext_r,
        score=score,
        q_seed_start=q_seed_start,
        s_seed_start=s_seed_start,
        edit_script=esp,
    )
