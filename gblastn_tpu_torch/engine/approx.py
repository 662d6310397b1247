"""Approximate nucleotide ungapped scoring (the reference's fast path).

For blastn-family searches with word_length >= 11, the reference does
NOT score every ungapped extension exactly: s_NuclUngappedExtend
(reference: NCBI c++/src/algo/blast/core/na_ungapped.c:263)
first scores the extension approximately -- four bases at a time off
the packed subject, via a 256-entry XOR table -- and only recomputes
exactly when the approximate score reaches the context's reduced
cutoff (0.9 * word cutoff, blast_parameters.c:412). A hit whose
byte-quantized score stays below the reduced cutoff keeps its (low)
approximate score and is then dropped by the cutoff test, EVEN IF its
exact score passes. This is observable output behavior: marginal hits
near the cutoff live or die by their byte alignment.

Our device kernels compute the exact extension for every seed (which
covers the escalated branch bit-for-bit); this module replicates the
approximate pass on the host for the few seeds whose exact score
passes the cutoff, deciding whether the reference would have escalated
them. The per-seed loop mirrors the C pointer walk exactly, including
the truncated-byte packing of query codes (ambiguity codes overflow
their 2-bit slot, as in the C).
"""
from __future__ import annotations

import numpy as np


def approx_ungapped_one(
    query: np.ndarray,      # uint8 concatenated BLASTNA buffer
    concat_end: int,        # reference query->length mapped to ours:
                            # one past the last real base (buffer index)
    packed: np.ndarray,     # uint8 packed database (pad-aligned subjects)
    sub_start: int,         # owning subject start, global base coords
    sub_end: int,           # owning subject end, global base coords
    q_off: int,             # seed offset, buffer coords
    s_off: int,             # seed offset, global base coords
    x_drop: int,
    table: np.ndarray,      # int32[256] packed score table
):
    """One seed's approximate bidirectional extension.

    Returns (score, q_start, s_start, q_right_end): query coords are
    buffer coords, subject global; q_right_end is the reference's
    ``new_q`` after the right pass (one PAST our convention: it points
    AT the last scored base, +1 applied by the caller's length math).
    """
    # reference coords: q indexes relative to query->sequence = our
    # buffer index minus the leading sentinel
    q_ref = q_off - 1
    s_loc = s_off - sub_start
    # the left extension begins behind the first 4-base boundary after
    # (q_off, s_off)
    adj = (4 - (s_loc & 3)) & 3
    q_ext = q_ref + adj
    s_ext = s_loc + adj
    sub_byte0 = sub_start >> 2          # pad-aligned: sub_start % 4 == 0

    score = 0
    sum_ = 0
    new_q = q_ext
    n_left = min(q_ext, s_ext) >> 2
    qb = q_ext + 1                      # our buffer index of q_ext
    sb = sub_byte0 + (s_ext >> 2)
    for i in range(n_left):
        s_byte = int(packed[sb - 1 - i])
        base = qb - 4 * (i + 1)
        q_byte = (
            (int(query[base]) << 6) | (int(query[base + 1]) << 4)
            | (int(query[base + 2]) << 2) | int(query[base + 3])
        ) & 0xFF
        sum_ += int(table[q_byte ^ s_byte])
        if sum_ > 0:
            new_q = q_ext - 4 * (i + 1)
            score += sum_
            sum_ = 0
        if sum_ < -x_drop:
            break

    q_start = new_q
    s_start = s_ext - (q_ext - q_start)

    # right pass begins at the first bases not examined above
    qlen_ref = concat_end - 1           # reference query->length
    slen = sub_end - sub_start
    sum_ = 0
    new_q = q_ext
    n_right = min(qlen_ref - q_ext, slen - s_ext) >> 2
    sb = sub_byte0 + (s_ext >> 2)
    for i in range(n_right):
        s_byte = int(packed[sb + i])
        base = qb + 4 * i
        q_byte = (
            (int(query[base]) << 6) | (int(query[base + 1]) << 4)
            | (int(query[base + 2]) << 2) | int(query[base + 3])
        ) & 0xFF
        sum_ += int(table[q_byte ^ s_byte])
        if sum_ > 0:
            new_q = q_ext + 4 * i + 3
            score += sum_
            sum_ = 0
        if sum_ < -x_drop:
            break

    return score, q_start, s_start, new_q


def compute_approx_info(
    query: np.ndarray,
    concat_end: int,
    packed: np.ndarray,
    sub_start: np.ndarray,   # int64[n] per-seed owning-subject start
    sub_end: np.ndarray,     # int64[n]
    q_off: np.ndarray,       # buffer coords
    s_off: np.ndarray,       # global coords
    ctx: np.ndarray,
    x_dropoffs: np.ndarray,  # per-context raw X-drop
    reduced: np.ndarray,     # per-context reduced cutoffs
    table: np.ndarray,
    need: np.ndarray,        # bool[n] seeds to evaluate
    use_native: bool | None = None,
):
    """Per-seed approximate-path verdicts for the diag replays.

    Returns (demote, a_score, a_q_start, a_s_start, a_q_right):
    demote[i] True when the reference would NOT have escalated seed i
    to the exact rescoring (approx score < reduced cutoff), so its
    exact score must not be used for hit saving.
    """
    n = len(q_off)
    demote = np.zeros(n, dtype=bool)
    a_score = np.zeros(n, np.int64)
    a_q = np.zeros(n, np.int64)
    a_s = np.zeros(n, np.int64)
    a_r = np.zeros(n, np.int64)
    if use_native is not False:
        from gblastn_tpu_torch.native import get_lib

        lib = get_lib()
        if lib is not None:
            qa = np.ascontiguousarray(query, np.uint8)
            pa = np.ascontiguousarray(packed, np.uint8)
            ta = np.ascontiguousarray(table, np.int32)
            sst = np.ascontiguousarray(sub_start, np.int64)
            sen = np.ascontiguousarray(sub_end, np.int64)
            qo = np.ascontiguousarray(q_off, np.int64)
            so = np.ascontiguousarray(s_off, np.int64)
            cx = np.ascontiguousarray(ctx, np.int32)
            xd = np.ascontiguousarray(x_dropoffs, np.int32)
            rd = np.ascontiguousarray(reduced, np.int64)
            ne = np.ascontiguousarray(need, np.uint8)
            dm = np.zeros(n, np.uint8)
            lib.gblastn_approx_ungapped(
                qa.ctypes.data, concat_end, pa.ctypes.data,
                ta.ctypes.data, n,
                sst.ctypes.data, sen.ctypes.data,
                qo.ctypes.data, so.ctypes.data, cx.ctypes.data,
                xd.ctypes.data, rd.ctypes.data, ne.ctypes.data,
                dm.ctypes.data, a_score.ctypes.data, a_q.ctypes.data,
                a_s.ctypes.data, a_r.ctypes.data,
            )
            return dm.astype(bool), a_score, a_q, a_s, a_r
    for i in np.nonzero(need)[0]:
        c = int(ctx[i])
        sc, qs, ss, qr = approx_ungapped_one(
            query, concat_end, packed,
            int(sub_start[i]), int(sub_end[i]),
            int(q_off[i]), int(s_off[i]),
            int(x_dropoffs[c]), table,
        )
        a_score[i] = sc
        # back to our coordinate conventions: buffer / global
        a_q[i] = qs + 1
        a_s[i] = ss + int(sub_start[i])
        a_r[i] = qr + 1
        demote[i] = sc < int(reduced[c])
    return demote, a_score, a_q, a_s, a_r
