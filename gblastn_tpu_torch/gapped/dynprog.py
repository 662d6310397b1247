"""Dynamic-programming gapped extension with X-drop (blastn task).

Host-side reimplementation of the reference semi-gapped aligner
(reference: NCBI c++/src/algo/blast/core/blast_gapalign.c):

* ``semi_gapped_align``   -- Blast_SemiGappedAlign score-only (:744) and
  ALIGN_EX with traceback (:350): banded-by-X-drop affine DP over
  (A rows x B columns), row window [first_b_index, b_size) advancing
  under the X-drop test, traceback bits SUB/GAP_IN_A/GAP_IN_B plus
  gap-extension flags;
* ``dyn_prog_nt_gapped_alignment`` -- s_BlastDynProgNtGappedAlignment
  (:2762): the prelim score-only driver with the subject byte-boundary
  start adjustment (A=subject, B=query; the BLASTNA matrix is symmetric
  so the swapped orientation scores identically);
* ``gapped_alignment_with_traceback`` -- BLAST_GappedAlignmentWithTraceback
  (:3994): left extension includes the start point, right excludes it;
  prelim edit blocks are combined exactly as for greedy.

This is the exact-parity oracle; the C++ fast path must match it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gblastn_tpu_torch.gapped.greedy import GappedResult, _combine_prelim_blocks
from gblastn_tpu_torch.hits import OP_DEL, OP_INS, OP_SUB, EditScript

MININT = -(2**31) // 2

SCRIPT_SUB = OP_SUB
SCRIPT_GAP_IN_A = OP_DEL      # gap in A
SCRIPT_GAP_IN_B = OP_INS      # gap in B
SCRIPT_OP_MASK = 0x07
SCRIPT_EXTEND_GAP_A = 0x10
SCRIPT_EXTEND_GAP_B = 0x40


def semi_gapped_align_native(
    A: np.ndarray,
    B: np.ndarray,
    M: int,
    N: int,
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
    x_dropoff: int,
    reverse_sequence: bool,
    score_only: bool = True,
) -> tuple[int, int, int, EditScript | None] | None:
    """Dispatch to the C++ DP aligner (native/dynprog.cpp); None if the
    native library is unavailable."""
    from gblastn_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "gblastn_semi_gapped_align"):
        return None
    import ctypes

    a = np.ascontiguousarray(A, dtype=np.uint8)
    b = np.ascontiguousarray(B, dtype=np.uint8)
    m = np.ascontiguousarray(matrix, dtype=np.int32)
    out = np.zeros(4, dtype=np.int64)
    max_ops = 256
    while True:
        op_types = np.zeros(max_ops, dtype=np.int32)
        op_nums = np.zeros(max_ops, dtype=np.int32)
        rc = lib.gblastn_semi_gapped_align(
            a.ctypes.data, len(a),
            b.ctypes.data, len(b),
            int(M), int(N),
            m.ctypes.data,
            int(gap_open), int(gap_extend), int(x_dropoff),
            int(reverse_sequence), int(score_only),
            op_types.ctypes.data,
            op_nums.ctypes.data,
            max_ops,
            out.ctypes.data,
        )
        if rc == 0:
            break
        max_ops *= 4
        if max_ops > 1 << 24:
            return None
    ops: EditScript | None = None
    if not score_only:
        n = int(out[3])
        ops = [(int(op_types[i]), int(op_nums[i])) for i in range(n)]
    return int(out[0]), int(out[1]), int(out[2]), ops


def semi_gapped_align(
    A: np.ndarray,
    B: np.ndarray,
    M: int,
    N: int,
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
    x_dropoff: int,
    reverse_sequence: bool,
    score_only: bool = True,
    use_native: bool = True,
) -> tuple[int, int, int, EditScript | None]:
    """Returns (best_score, a_offset, b_offset, edit_ops).

    A is indexed A[a_index] (forward, a_index starts at 1 -- i.e. A[0]
    is skipped, matching the C pointer convention) or A[M - a_index]
    (reverse). B likewise B[b_index + 1] / B[N - 1 - b_index].
    edit_ops (traceback mode) is the prelim block: single-step ops
    emitted walking backwards from the best cell.
    """
    if use_native:
        res = semi_gapped_align_native(
            A, B, M, N, matrix, gap_open, gap_extend, x_dropoff,
            reverse_sequence, score_only,
        )
        if res is not None:
            return res
    gap_open_extend = gap_open + gap_extend
    x_dropoff = max(x_dropoff, gap_open_extend)
    a_offset = 0
    b_offset = 0
    if N <= 0 or M <= 0:
        return 0, 0, 0, ([] if not score_only else None)

    best = np.zeros(N + 2, dtype=np.int64)
    best_gap = np.zeros(N + 2, dtype=np.int64)

    # edit script rows (traceback only): row a -> array over b range
    tb_rows: list[np.ndarray] = []
    tb_starts: list[int] = []

    score = -gap_open_extend
    best[0] = 0
    best_gap[0] = -gap_open_extend
    row0 = np.zeros(N + 2, dtype=np.uint8)
    i = 1
    while i <= N:
        if score < -x_dropoff:
            break
        best[i] = score
        best_gap[i] = score - gap_open_extend
        score -= gap_extend
        row0[i] = SCRIPT_GAP_IN_A
        i += 1
    b_size = i
    if not score_only:
        tb_rows.append(row0)
        tb_starts.append(0)

    best_score = 0
    first_b_index = 0

    a_index = 1
    while a_index <= M:
        if reverse_sequence:
            a_code = int(A[M - a_index])
        else:
            a_code = int(A[a_index])
        matrix_row = matrix[a_code]

        row = None
        if not score_only:
            row = np.zeros(max(b_size - first_b_index + 2, 2),
                           dtype=np.uint8)
            tb_rows.append(row)
            tb_starts.append(first_b_index)

        score = MININT
        score_gap_row = MININT
        last_b_index = first_b_index

        b_index = first_b_index
        while b_index < b_size:
            # out-of-range B reads hit the sentinel byte in the reference
            # buffers (score INT4_MIN/2); emulate explicitly
            if reverse_sequence:
                bi = N - 1 - b_index
            else:
                bi = b_index + 1
            if 0 <= bi < len(B):
                msc = int(matrix_row[int(B[bi])])
            else:
                msc = MININT
            score_gap_col = int(best_gap[b_index])
            next_score = int(best[b_index]) + msc

            script = SCRIPT_SUB
            if score < score_gap_col:
                script = SCRIPT_GAP_IN_B
                score = score_gap_col
            if score < score_gap_row:
                script = SCRIPT_GAP_IN_A
                score = score_gap_row

            if best_score - score > x_dropoff:
                if first_b_index == b_index:
                    first_b_index += 1
                else:
                    best[b_index] = MININT
            else:
                last_b_index = b_index
                if score > best_score:
                    best_score = score
                    a_offset = a_index
                    b_offset = b_index

                score_gap_row -= gap_extend
                score_gap_col -= gap_extend
                if score_gap_col < score - gap_open_extend:
                    best_gap[b_index] = score - gap_open_extend
                else:
                    best_gap[b_index] = score_gap_col
                    script += SCRIPT_EXTEND_GAP_B
                if score_gap_row < score - gap_open_extend:
                    score_gap_row = score - gap_open_extend
                else:
                    script += SCRIPT_EXTEND_GAP_A
                best[b_index] = score

            score = next_score
            if row is not None:
                # rows index from their creation-time first_b_index even
                # if the live first_b_index advances (ALIGN_EX :515)
                idx = b_index - tb_starts[a_index]
                if idx >= len(row):
                    row = np.concatenate(
                        [row, np.zeros(idx + 16, dtype=np.uint8)]
                    )
                    tb_rows[a_index] = row
                row[idx] = script
            b_index += 1

        if first_b_index == b_size:
            break

        if last_b_index < b_size - 1:
            b_size = last_b_index + 1
        else:
            while score_gap_row >= best_score - x_dropoff and b_size <= N:
                if b_size + 2 >= len(best):
                    best = np.concatenate(
                        [best, np.zeros(N + 2, dtype=np.int64)]
                    )
                    best_gap = np.concatenate(
                        [best_gap, np.zeros(N + 2, dtype=np.int64)]
                    )
                best[b_size] = score_gap_row
                best_gap[b_size] = score_gap_row - gap_open_extend
                score_gap_row -= gap_extend
                if row is not None:
                    idx = b_size - tb_starts[a_index]
                    if idx >= len(row):
                        row = np.concatenate(
                            [row, np.zeros(idx + 16, dtype=np.uint8)]
                        )
                        tb_rows[a_index] = row
                    row[idx] = SCRIPT_GAP_IN_A
                b_size += 1

        if b_size <= N:
            best[b_size] = MININT
            best_gap[b_size] = MININT
            b_size += 1
        a_index += 1

    if score_only:
        return best_score, a_offset, b_offset, None

    # traceback walk (ALIGN_EX :645)
    ops: EditScript = []
    a_index = a_offset
    b_index = b_offset
    script = SCRIPT_SUB
    while a_index > 0 or b_index > 0:
        next_script = int(
            tb_rows[a_index][b_index - tb_starts[a_index]]
        )
        if script == SCRIPT_GAP_IN_A:
            script = next_script & SCRIPT_OP_MASK
            if next_script & SCRIPT_EXTEND_GAP_A:
                script = SCRIPT_GAP_IN_A
        elif script == SCRIPT_GAP_IN_B:
            script = next_script & SCRIPT_OP_MASK
            if next_script & SCRIPT_EXTEND_GAP_B:
                script = SCRIPT_GAP_IN_B
        else:
            script = next_script & SCRIPT_OP_MASK

        if script == SCRIPT_GAP_IN_A:
            b_index -= 1
        elif script == SCRIPT_GAP_IN_B:
            a_index -= 1
        else:
            a_index -= 1
            b_index -= 1
        if ops and ops[-1][0] == script:
            ops[-1] = (script, ops[-1][1] + 1)
        else:
            ops.append((script, 1))
    return best_score, a_offset, b_offset, ops


COMPRESSION_RATIO = 4


def dyn_prog_nt_gapped_alignment(
    query: np.ndarray,         # uint8 BLASTNA context-local query
    subject2: np.ndarray,      # uint8 2-bit subject codes
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
    gap_x_dropoff: int,
    q_off: int,
    s_off: int,
) -> GappedResult:
    """s_BlastDynProgNtGappedAlignment (blast_gapalign.c:2762),
    score-only prelim extension. A=subject, B=query (symmetric matrix).
    """
    query_length = len(query)
    subject_length = len(subject2)
    offset_adjustment = COMPRESSION_RATIO - (s_off % COMPRESSION_RATIO)
    q_length = q_off + offset_adjustment
    s_length = s_off + offset_adjustment
    if q_length > query_length or s_length > subject_length:
        q_length -= COMPRESSION_RATIO
        s_length -= COMPRESSION_RATIO

    # left extension (reverse): A=subject[0:s_length], B=query[0:q_length]
    score_left, a_ext_l, b_ext_l, _ = semi_gapped_align(
        subject2, query, s_length, q_length, matrix,
        gap_open, gap_extend, gap_x_dropoff,
        reverse_sequence=True,
    )
    q_start = q_length - b_ext_l
    s_start = s_length - a_ext_l

    score_right = 0
    q_stop, s_stop = q_length, s_length
    if q_length < query_length and s_length < subject_length:
        # right: A = subject from s_length (A[0] skipped: pass base-1)
        score_right, a_ext_r, b_ext_r, _ = semi_gapped_align(
            subject2[s_length - 1:], query[q_length - 1:],
            subject_length - s_length, query_length - q_length, matrix,
            gap_open, gap_extend, gap_x_dropoff,
            reverse_sequence=False,
        )
        q_stop = b_ext_r + q_length
        s_stop = a_ext_r + s_length

    return GappedResult(
        q_start=q_start, q_end=q_stop, s_start=s_start, s_end=s_stop,
        score=score_left + score_right,
        q_seed_start=q_off, s_seed_start=s_off,
        edit_script=None,
    )


def dp_gapped_traceback_native(
    query, subject, matrix, gap_open, gap_extend, gap_x_dropoff_final,
    q_start, s_start,
) -> GappedResult | None:
    """One fused native call for the DP traceback extension (left +
    right + combine, native/dynprog.cpp); None = Python driver."""
    from gblastn_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "gblastn_dp_gapped_traceback"):
        return None
    qa = np.ascontiguousarray(query, dtype=np.uint8)
    sa = np.ascontiguousarray(subject, dtype=np.uint8)
    m = np.ascontiguousarray(matrix, dtype=np.int32)
    out = np.empty(6, dtype=np.int64)
    max_ops = 256
    while True:
        op_types = np.empty(max_ops, dtype=np.int32)
        op_nums = np.empty(max_ops, dtype=np.int32)
        rc = lib.gblastn_dp_gapped_traceback(
            qa.ctypes.data, len(qa), sa.ctypes.data, len(sa),
            m.ctypes.data,
            int(gap_open), int(gap_extend), int(gap_x_dropoff_final),
            int(q_start), int(s_start),
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
        q_seed_start=q_start, s_seed_start=s_start,
        edit_script=esp,
    )


def gapped_alignment_with_traceback(
    query: np.ndarray,        # uint8 BLASTNA
    subject: np.ndarray,      # uint8 BLASTNA (true ambiguities)
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
    gap_x_dropoff_final: int,
    q_start: int,
    s_start: int,
    use_native: bool | None = None,
) -> GappedResult:
    """BLAST_GappedAlignmentWithTraceback (blast_gapalign.c:3994).
    Left extension includes [q_start, s_start]; right excludes it."""
    if use_native is not False:
        res = dp_gapped_traceback_native(
            query, subject, matrix, gap_open, gap_extend,
            gap_x_dropoff_final, q_start, s_start,
        )
        if res is not None:
            return res
    q_length = len(query)
    s_length = len(subject)

    score_left, q_ext_l, s_ext_l, rev_ops = semi_gapped_align(
        query, subject, q_start + 1, s_start + 1, matrix,
        gap_open, gap_extend, gap_x_dropoff_final,
        reverse_sequence=True, score_only=False,
    )
    query_start = q_start - q_ext_l + 1
    subject_start = s_start - s_ext_l + 1

    score_right = 0
    fwd_ops: EditScript = []
    if q_start < q_length and s_start < s_length:
        score_right, q_ext_r, s_ext_r, fwd_ops = semi_gapped_align(
            query[q_start:], subject[s_start:],
            q_length - q_start - 1, s_length - s_start - 1, matrix,
            gap_open, gap_extend, gap_x_dropoff_final,
            reverse_sequence=False, score_only=False,
        )
        query_stop = q_start + q_ext_r + 1
        subject_stop = s_start + s_ext_r + 1
    else:
        query_stop = q_start - 1
        subject_stop = s_start - 1

    # ALIGN_EX reverse pass emits ops walking back to the start, which in
    # reversed coordinates is forward order: do NOT reverse rev_ops; the
    # forward pass ops must be reversed (Blast_PrelimEditBlockToGapEditScript)
    esp = _combine_prelim_blocks(rev_ops or [], fwd_ops or [])
    return GappedResult(
        q_start=query_start, q_end=query_stop,
        s_start=subject_start, s_end=subject_stop,
        score=score_left + score_right,
        q_seed_start=q_start, s_seed_start=s_start,
        edit_script=esp,
    )
