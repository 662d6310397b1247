"""Traceback stage: re-align saved HSPs with traceback and finalize.

Host-side reimplementation of ``Blast_TracebackFromHSPList`` for the
nucleotide greedy path (reference:
NCBI c++/src/algo/blast/core/blast_traceback.c:336-792):

1. per HSP (score order): containment pruning against already-finished
   HSPs; start-point validation (``BLAST_CheckStartForGappedAlignment``
   :97) and refinement (``BlastGetStartForGappedAlignmentNucl``,
   blast_gapalign.c:3134); subject-window clamp (``AdjustSubjectRange``
   :3607); greedy re-extension WITH traceback;
2. common-endpoint purge in keep-and-cut mode;
3. greedy path: re-score every HSP against the true (ambiguity-bearing)
   subject (``Blast_HSPReevaluateWithAmbiguitiesGapped``,
   blast_hits.c:350), identity/length test, second containment purge;
4. post-update (:278): odd-score rounding, e-values, reap, bit scores.

The subject here is BLASTNA codes with true ambiguity codes restored
(the reference fetches eBlastEncodingNucleotide for traceback).
"""
from __future__ import annotations

import numpy as np

from gblastn_tpu_torch.gapped.dynprog import gapped_alignment_with_traceback
from gblastn_tpu_torch.gapped.greedy import greedy_gapped_alignment
from gblastn_tpu_torch.hits import (
    HSP,
    HSPList,
    OP_DEL,
    OP_INS,
    OP_SUB,
    adjust_odd_scores,
    get_bit_scores,
    get_evalues,
    ContainmentIndex,
    purge_common_endpoints,
    reap_by_evalue,
    sort_by_score,
)
from gblastn_tpu_torch.io.query import QueryBlock
from gblastn_tpu_torch.params.derived import SearchParams
from gblastn_tpu_torch.params.options import ExtensionMethod

HSP_MAX_WINDOW = 11          # blast_gapalign_priv.h:120
MAX_SUBJECT_OFFSET = 90000   # blast_gapalign.c:3600
MAX_TOTAL_GAPS = 3000        # blast_gapalign.c:3605


def check_start_for_gapped_alignment(
    hsp: HSP, query: np.ndarray, subject: np.ndarray, matrix: np.ndarray
) -> bool:
    """BLAST_CheckStartForGappedAlignment (blast_traceback.c:97)."""
    left = -(HSP_MAX_WINDOW // 2)
    left = max(left, hsp.q_off - hsp.q_gapped_start)
    left = max(left, hsp.s_off - hsp.s_gapped_start)
    right = HSP_MAX_WINDOW // 2 + 1
    right = min(right, hsp.q_end - hsp.q_gapped_start)
    right = min(right, hsp.s_end - hsp.s_gapped_start)
    q = query[hsp.q_gapped_start + left: hsp.q_gapped_start + right]
    s = subject[hsp.s_gapped_start + left: hsp.s_gapped_start + right]
    n = min(len(q), len(s))
    if n <= 0:
        return False
    score = int(matrix[q[:n].astype(np.intp), s[:n].astype(np.intp)].sum())
    return score > 0


def get_start_for_gapped_alignment_nucl(
    query: np.ndarray, subject: np.ndarray, hsp: HSP
) -> None:
    """BlastGetStartForGappedAlignmentNucl (blast_gapalign.c:3134):
    move the gapped start to the center of a long identity run."""
    HSP_MAX_IDENT_RUN = 20
    offset = min(
        hsp.s_gapped_start - hsp.s_off, hsp.q_gapped_start - hsp.q_off
    )
    q_start = hsp.q_gapped_start - offset
    s_start = hsp.s_gapped_start - offset
    q_len = min(hsp.s_end - s_start, hsp.q_end - q_start)
    if q_len <= 0:
        return
    q = query[q_start: q_start + q_len]
    s = subject[s_start: s_start + q_len]
    max_score = 0
    max_offset = q_start
    score = 0
    prev_match = False
    match = False
    index = q_start
    for index in range(q_start, q_start + q_len):
        match = bool(q[index - q_start] == s[index - q_start])
        if match != prev_match:
            prev_match = match
            if match:
                score = 1
            elif score > max_score:
                max_score = score
                max_offset = index - score // 2
        elif match:
            score += 1
            if score > HSP_MAX_IDENT_RUN:
                max_offset = index - HSP_MAX_IDENT_RUN // 2
                hsp.q_gapped_start = max_offset
                hsp.s_gapped_start = max_offset + s_start - q_start
                return
    index = q_start + q_len  # C loop leaves index == end
    if match and score > max_score:
        max_score = score
        max_offset = index - score // 2
    if max_score > 0:
        hsp.q_gapped_start = max_offset
        hsp.s_gapped_start = max_offset + s_start - q_start


def get_offsets_for_gapped_alignment(
    query: np.ndarray, subject: np.ndarray, matrix: np.ndarray, hsp: HSP
) -> tuple[bool, int, int]:
    """BlastGetOffsetsForGappedAlignment (blast_gapalign.c:3058):
    best-scoring HSP_MAX_WINDOW window inside the HSP."""
    q_length = hsp.q_end - hsp.q_off
    s_length = hsp.s_end - hsp.s_off
    q_start, s_start = hsp.q_off, hsp.s_off
    if q_length <= HSP_MAX_WINDOW:
        return True, q_start + q_length // 2, s_start + q_length // 2
    n = min(q_length, s_length)
    q = query[q_start: q_start + n].astype(np.intp)
    s = subject[s_start: s_start + n].astype(np.intp)
    scores = matrix[q, s].astype(np.int64)
    win = np.convolve(scores, np.ones(HSP_MAX_WINDOW, np.int64), "valid")
    # first window is [q_start, q_start+W); its "offset" is end-1
    max_i = int(np.argmax(win))
    max_score = int(win[max_i])
    max_offset = q_start + max_i + HSP_MAX_WINDOW - 1
    if max_score > 0:
        max_offset -= HSP_MAX_WINDOW // 2
        return True, max_offset, (max_offset - q_start) + s_start
    # test the window around the end of the HSP (blast_gapalign.c:3112)
    qe = query[q_start + q_length - HSP_MAX_WINDOW: q_start + q_length]
    se = subject[s_start + s_length - HSP_MAX_WINDOW: s_start + s_length]
    ne = min(len(qe), len(se))
    score = int(matrix[qe[:ne].astype(np.intp), se[:ne].astype(np.intp)].sum())
    if score > 0:
        return (
            True,
            hsp.q_end - HSP_MAX_WINDOW // 2,
            hsp.s_end - HSP_MAX_WINDOW // 2,
        )
    return False, 0, 0


def adjust_subject_range(
    s_offset: int, s_length: int, q_offset: int, q_length: int
) -> tuple[int, int, int]:
    """AdjustSubjectRange (blast_gapalign.c:3607).
    Returns (new_s_offset, new_s_length, start_shift)."""
    if s_length < MAX_SUBJECT_OFFSET:
        return s_offset, s_length, 0
    max_extension_left = q_offset + MAX_TOTAL_GAPS
    max_extension_right = q_length - q_offset + MAX_TOTAL_GAPS
    if s_offset <= max_extension_left:
        start_shift = 0
        new_off = s_offset
    else:
        start_shift = s_offset - max_extension_left
        new_off = max_extension_left
    new_len = min(s_length, s_offset + max_extension_right) - start_shift
    return new_off, new_len, start_shift


def reevaluate_with_ambiguities_gapped(
    hsp: HSP,
    q: np.ndarray,
    s: np.ndarray,
    matrix: np.ndarray,
    cutoff_score: int,
    reward: int,
    penalty: int,
    gap_open: int,
    gap_extend: int,
    use_native: bool | None = None,
) -> bool:
    """Blast_HSPReevaluateWithAmbiguitiesGapped (blast_hits.c:350).

    Re-scores the edit script against the true subject, keeps the best
    scoring contiguous section, extends it by flanking exact matches, and
    updates the HSP in place. Returns True if the HSP should be deleted.
    Runs native (native/reevaluate.cpp) when available.
    """
    if not hsp.edit_script:
        return True

    if use_native is not False:
        from gblastn_tpu_torch.native import get_lib

        lib = get_lib()
        if lib is not None:
            import ctypes

            n = len(hsp.edit_script)
            ops = np.array([op for op, _ in hsp.edit_script], np.int8)
            nums = np.array([num for _, num in hsp.edit_script],
                            np.int64)
            m256 = np.ascontiguousarray(
                np.asarray(matrix, np.int32)[:16, :16]
            )
            qa = np.ascontiguousarray(q, np.uint8)
            sa = np.ascontiguousarray(s, np.uint8)
            out = np.zeros(8, np.int64)
            r = lib.gblastn_reevaluate_gapped(
                qa.ctypes.data, len(qa),
                sa.ctypes.data, len(sa),
                m256.ctypes.data,
                hsp.q_off, hsp.s_off, cutoff_score,
                reward, penalty, gap_open, gap_extend,
                ops.ctypes.data,
                nums.ctypes.data, n,
                out.ctypes.data,
            )
            hsp.score = int(out[0])
            if r < 0:
                return True
            hsp.q_off = int(out[1])
            hsp.q_end = int(out[2])
            hsp.s_off = int(out[3])
            hsp.s_end = int(out[4])
            hsp.edit_script = [
                (int(ops[i]), int(nums[i])) for i in range(r)
            ]
            return False
    if gap_open == 0 and gap_extend == 0:
        factor = 2 if reward % 2 == 1 else 1
        g_open = 0
        g_extend = (reward - 2 * penalty) * factor // 2
    else:
        factor = 1
        g_open = gap_open
        g_extend = gap_extend

    esp = [list(x) for x in hsp.edit_script]
    qi = hsp.q_off
    si = hsp.s_off
    score = 0
    sum_ = 0
    best_q_start = best_q_end = qi
    best_s_start = best_s_end = si
    current_q_start, current_s_start = qi, si
    best_start_esp_index = 0
    best_end_esp_index = 0
    current_start_esp_index = 0
    best_end_esp_num = -1

    for index in range(len(esp)):
        op, num = esp[index][0], esp[index][1]
        op_index = 0
        while op_index < num:
            if op == OP_SUB:
                sum_ += factor * int(matrix[int(q[qi]) & 0x0F, int(s[si])])
                qi += 1
                si += 1
                op_index += 1
            elif op == OP_DEL:
                sum_ -= g_open + g_extend * num
                si += num
                op_index += num
            else:  # OP_INS
                sum_ -= g_open + g_extend * num
                qi += num
                op_index += num

            if sum_ < 0:
                if op_index < num:
                    esp[index][1] -= op_index
                    num = esp[index][1]
                    current_start_esp_index = index
                    op_index = 0
                else:
                    current_start_esp_index = index + 1
                sum_ = 0
                current_q_start = qi
                current_s_start = si
                if score < cutoff_score:
                    best_q_start = qi
                    best_s_start = si
                    score = 0
                    best_start_esp_index = current_start_esp_index
                    best_end_esp_index = current_start_esp_index
            elif sum_ > score:
                score = sum_
                best_q_start = current_q_start
                best_s_start = current_s_start
                best_q_end = qi
                best_s_end = si
                best_start_esp_index = current_start_esp_index
                best_end_esp_index = index
                best_end_esp_num = op_index

    score //= factor

    if best_start_esp_index < len(esp) and best_end_esp_index < len(esp):
        # flanking exact-match extension (blast_hits.c:489-510)
        qp, sp = best_q_start, best_s_start
        ext = 0
        while qp > 0 and sp > 0 and q[qp - 1] == s[sp - 1] and q[qp - 1] < 4:
            qp -= 1
            sp -= 1
            ext += 1
        best_q_start -= ext
        best_s_start -= ext
        esp[best_start_esp_index][1] += ext
        if best_end_esp_index == best_start_esp_index:
            best_end_esp_num += ext
        score += ext * reward

        qp, sp = best_q_end, best_s_end
        ext = 0
        qlen, slen = len(q), len(s)
        while qp < qlen and sp < slen and q[qp] < 4 and q[qp] == s[sp]:
            qp += 1
            sp += 1
            ext += 1
        best_q_end += ext
        best_s_end += ext
        esp[best_end_esp_index][1] += ext
        best_end_esp_num += ext
        score += ext * reward

    # s_UpdateReevaluatedHSP (blast_hits.c:311)
    hsp.score = score
    if score < cutoff_score:
        return True
    hsp.q_off = best_q_start
    hsp.q_end = best_q_end
    hsp.s_off = best_s_start
    hsp.s_end = best_s_end
    new_esp = esp[best_start_esp_index: best_end_esp_index + 1]
    if new_esp:
        new_esp[-1][1] = best_end_esp_num
    hsp.edit_script = [(op, num) for op, num in new_esp]
    return False


def num_identities(
    q: np.ndarray, s: np.ndarray, hsp: HSP
) -> tuple[int, int]:
    """s_Blast_HSPGetNumIdentitiesAndPositives (blast_hits.c:618).
    Returns (num_ident, align_length)."""
    qi, si = hsp.q_off, hsp.s_off
    num_ident = 0
    align_length = 0
    if not hsp.edit_script:
        n = hsp.q_end - hsp.q_off
        align_length = n
        num_ident = int(
            (q[qi: qi + n] == s[si: si + n]).sum()
        )
        return num_ident, align_length
    for op, num in hsp.edit_script:
        align_length += num
        if op == OP_SUB:
            num_ident += int((q[qi: qi + num] == s[si: si + num]).sum())
            qi += num
            si += num
        elif op == OP_DEL:
            si += num
        else:
            qi += num
    return num_ident, align_length


def hsp_test(
    hsp: HSP, align_length: int, percent_identity: float,
    min_hit_length: int = 0,
) -> bool:
    """s_HSPTest (blast_hits.c:861): True if the HSP should be deleted."""
    return (
        hsp.num_ident * 100.0 < align_length * percent_identity
        or align_length < min_hit_length
    )


def traceback_from_hsplist(
    hsp_list: HSPList,
    qblock: QueryBlock,
    subject: np.ndarray,        # uint8 BLASTNA subject with true ambiguities
    matrix: np.ndarray,         # int32[16,16] BLASTNA matrix
    params: SearchParams,
) -> None:
    """Blast_TracebackFromHSPList (blast_traceback.c:336), greedy path.

    Updates hsp_list in place: HSPs are re-aligned with traceback,
    rescored against true bases, filtered, and finalized with e-values
    and bit scores. Coordinates are context-local (query) and
    subject-local.
    """
    opts = params.options
    greedy = opts.extension_method is ExtensionMethod.GREEDY
    ctx_offsets = qblock.context_offsets()
    subject_length = len(subject)
    finished = ContainmentIndex(
        opts.min_diag_separation, q_span=len(qblock.buffer) + 1
    )
    result: list[HSP] = []

    for hsp in hsp_list.hsps:
        ctx = hsp.context
        q0 = int(ctx_offsets[ctx])
        q_len = qblock.contexts[ctx].length
        query = qblock.buffer[q0: q0 + q_len]

        if finished.contains(
            hsp.q_off, hsp.q_end, hsp.s_off, hsp.s_end, hsp.score, ctx,
        ):
            continue

        if (
            hsp.q_gapped_start == 0 and hsp.s_gapped_start == 0
        ) or not check_start_for_gapped_alignment(hsp, query, subject, matrix):
            ok, q_start, s_start = get_offsets_for_gapped_alignment(
                query, subject, matrix, hsp
            )
            if not ok:
                continue
            hsp.q_gapped_start = q_start
            hsp.s_gapped_start = s_start
        else:
            get_start_for_gapped_alignment_nucl(query, subject, hsp)
        q_start = hsp.q_gapped_start
        s_start = hsp.s_gapped_start

        s_start_adj, adj_s_length, start_shift = adjust_subject_range(
            s_start, subject_length, q_start, q_len
        )
        hsp.s_gapped_start = s_start_adj
        adjusted_subject = subject[start_shift: start_shift + adj_s_length]

        if greedy:
            res = greedy_gapped_alignment(
                query, adjusted_subject, params.gap_x_dropoff_final,
                opts.reward, opts.penalty, opts.gap_open, opts.gap_extend,
                q_start, s_start_adj, do_traceback=True,
            )
        else:
            res = gapped_alignment_with_traceback(
                query, adjusted_subject, matrix,
                opts.gap_open, opts.gap_extend, params.gap_x_dropoff_final,
                q_start, s_start_adj,
            )
        # Blast_HSPUpdateWithTraceback (blast_traceback.c:157)
        hsp.score = res.score
        hsp.q_off = res.q_start
        hsp.q_end = res.q_end
        hsp.s_off = res.s_start
        hsp.s_end = res.s_end
        hsp.edit_script = res.edit_script

        # Blast_HSPAdjustSubjectOffset (blast_hits.c:1167)
        if start_shift > 0:
            hsp.s_off += start_shift
            hsp.s_end += start_shift
            hsp.s_gapped_start += start_shift

        if not greedy:
            # non-greedy: identity/length test inside the loop
            # (blast_traceback.c:657-668); identities count against the
            # UNMASKED letters (sequence_nomask, blast_hits.c:618)
            q0n = int(ctx_offsets[ctx])
            query_nomask = qblock.display_buffer[q0n: q0n + q_len]
            ni, align_len = num_identities(query_nomask, subject, hsp)
            hsp.num_ident = ni
            if hsp_test(hsp, align_len, opts.percent_identity):
                continue

        finished.add(hsp)
        result.append(hsp)

    # keep-and-cut purge (blast_traceback.c:710, purge=FALSE for blastn)
    result = purge_common_endpoints(result, purge=False)

    # greedy ignores ambiguities: re-score every HSP; the DP path only
    # rescores HSPs the purge cut back (blast_traceback.c:712-719)
    kept: list[HSP] = []
    for hsp in result:
        if not greedy and not hsp.was_cut:
            kept.append(hsp)
            continue
        ctx = hsp.context
        q0 = int(ctx_offsets[ctx])
        q_len = qblock.contexts[ctx].length
        query = qblock.buffer[q0: q0 + q_len]
        query_nomask = qblock.display_buffer[q0: q0 + q_len]
        delete = reevaluate_with_ambiguities_gapped(
            hsp, query, subject, matrix,
            params.contexts[ctx].cutoff_score,
            opts.reward, opts.penalty, opts.gap_open, opts.gap_extend,
        )
        if not delete:
            ni, align_len = num_identities(query_nomask, subject, hsp)
            hsp.num_ident = ni
            delete = hsp_test(hsp, align_len, opts.percent_identity)
        if not delete:
            kept.append(hsp)

    sort_by_score(kept)

    # second containment purge (blast_traceback.c:743)
    final: list[HSP] = []
    final_index = ContainmentIndex(
        opts.min_diag_separation, q_span=len(qblock.buffer) + 1
    )
    for hsp in kept:
        if not final_index.contains_hsp(hsp):
            final.append(hsp)
            final_index.add(hsp)

    # s_HSPListPostTracebackUpdate (blast_traceback.c:278)
    adjust_odd_scores(final, params.round_down)
    hsp_list.hsps = final
    eff_searchsp = {
        c: params.contexts[c].eff_searchsp
        for c in range(len(params.contexts))
    }
    get_evalues(hsp_list, params.kbp_gap, eff_searchsp)
    reap_by_evalue(hsp_list, opts.evalue)
    get_bit_scores(hsp_list, params.kbp_gap)
    if hsp_list.hsps:
        hsp_list.best_evalue = min(h.evalue for h in hsp_list.hsps)
