"""Ungapped search mode (-ungapped): HSPs from the ungapped extension
stage, e-values by even-gap sum-statistics linking.

Reference flow: BLAST_GetUngappedHSPList (blast_gapalign.c:4157)
builds the HSP list straight from the initial hits;
s_BlastSearchEngineCore then links with Blast_EvenGapLinkHSPs instead
of plain e-values because ungapped searches always use sum statistics
(blast_options.c:1364-1373, blast_engine.c:773-777), and reaps by
e-value. The traceback stage re-scores against the ambiguity-restored
subject and re-links (blast_traceback.c).
"""
from __future__ import annotations

import numpy as np

from gblastn_tpu_torch.hits import HSP, HSPList, get_bit_scores, reap_by_evalue
from gblastn_tpu_torch.linking import even_gap_link_hsps
from gblastn_tpu_torch.traceback.stage import hsp_test, num_identities
from gblastn_tpu_torch.utils.profiling import slog


def _link_and_reap(hsps, params, subject_length):
    kbp = {c: params.kbp_gap for c in range(len(params.contexts))}
    hsps = even_gap_link_hsps(
        hsps, kbp, params.contexts, subject_length,
        cutoff_small_gap=params.word_cutoff_score_min,
    )
    return hsps


def run_ungapped_prelim(
    init,
    qblock,
    subject_starts: np.ndarray,
    subject_lengths: np.ndarray,
    params,
) -> list[HSPList]:
    """Ungapped prelim stage: init hits -> linked, reaped HSP lists."""
    out: list[HSPList] = []
    if len(init) == 0:
        return out
    ctx_offsets = qblock.context_offsets()
    oids = np.asarray(init.oid)

    for oid in np.unique(oids):
        idx = np.flatnonzero(oids == oid)
        hsps: list[HSP] = []
        for i in idx:
            ctx = int(init.context[i])
            ctx_info = qblock.contexts[ctx]
            q0 = int(init.q_start[i]) - int(ctx_offsets[ctx])
            s0 = int(init.s_start[i]) - int(subject_starts[int(oid)])
            n = int(init.length[i])
            hsps.append(
                HSP(
                    q_off=q0, q_end=q0 + n, s_off=s0, s_end=s0 + n,
                    score=int(init.score[i]), context=ctx,
                    q_frame=ctx_info.frame, s_frame=1,
                    q_gapped_start=q0, s_gapped_start=s0,
                )
            )
        subject_length = int(subject_lengths[int(oid)])
        hsps = _link_and_reap(hsps, params, subject_length)
        lst = HSPList(oid=int(oid), hsps=hsps)
        reap_by_evalue(lst, params.options.evalue)
        if lst.hsps:
            lst.best_evalue = min(h.evalue for h in lst.hsps)
            out.append(lst)
    return out


def reevaluate_with_ambiguities_ungapped(
    hsp: HSP, q: np.ndarray, s: np.ndarray, matrix: np.ndarray,
    cutoff_score: int,
) -> bool:
    """Blast_HSPReevaluateWithAmbiguitiesUngapped (blast_hits.c:547):
    one best-scoring-section walk over the true bases -- NO flanking
    exact-match extension (unlike the gapped variant) -- against the
    context's WORD-level cutoff. Returns True to delete."""
    qi, si = hsp.q_off, hsp.s_off
    n = hsp.q_end - hsp.q_off
    score = 0
    sum_ = 0
    best_q_start = best_q_end = qi
    best_s_start = best_s_end = si
    cur_q, cur_s = qi, si
    for _ in range(n):
        sum_ += int(matrix[int(q[qi]) & 0x0F, int(s[si])])
        qi += 1
        si += 1
        if sum_ < 0:
            sum_ = 0
            cur_q, cur_s = qi, si
            if score < cutoff_score:
                best_q_start = best_q_end = qi
                best_s_start = best_s_end = si
                score = 0
        elif sum_ > score:
            score = sum_
            best_q_end, best_s_end = qi, si
            best_q_start, best_s_start = cur_q, cur_s
    # s_UpdateReevaluatedHSPUngapped (blast_hits.c:535)
    hsp.score = score
    if score < cutoff_score:
        return True
    hsp.q_off, hsp.q_end = best_q_start, best_q_end
    hsp.s_off, hsp.s_end = best_s_start, best_s_end
    return False


def finish_ungapped_hsplist(
    lst: HSPList,
    qblock,
    subject: np.ndarray,      # BLASTNA with true ambiguity codes
    matrix: np.ndarray,
    params,
    subject_length: int,
) -> None:
    """Traceback-stage finishing for ungapped HSPs
    (Blast_HSPListReevaluateUngapped, blast_hits.c:2305): re-score
    against the true subject with the WORD-level cutoff, re-link, reap,
    identities and bit scores."""
    kept: list[HSP] = []
    for h in lst.hsps:
        ctx_info = qblock.contexts[h.context]
        q = qblock.buffer[
            ctx_info.offset: ctx_info.offset + ctx_info.length
        ]
        cp = params.contexts[h.context]
        if reevaluate_with_ambiguities_ungapped(
            h, q, subject, matrix, cp.word_cutoff_score,
        ):
            continue
        # identities count against the UNMASKED letters; the identity/
        # length filter follows (blast_hits.c:2396-2406)
        q_nomask = qblock.display_buffer[
            ctx_info.offset: ctx_info.offset + ctx_info.length
        ]
        h.num_ident, align_len = num_identities(q_nomask, subject, h)
        if hsp_test(h, align_len, params.options.percent_identity):
            continue
        kept.append(h)
    kept = _link_and_reap(kept, params, subject_length)
    lst.hsps = kept
    reap_by_evalue(lst, params.options.evalue)
    if lst.hsps:
        get_bit_scores(lst, params.kbp_gap)
        lst.best_evalue = min(h.evalue for h in lst.hsps)
