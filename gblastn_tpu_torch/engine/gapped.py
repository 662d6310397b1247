"""Preliminary gapped extension stage (host side).

The port's copy of the host walk of ``gblastn_tpu/engine/gapped.py``
(``BLAST_GetGappedScore``, NCBI blast_gapalign.c:3233, and the
per-subject post-processing of blast_engine.c:503-509, :792-812), taking
the port's ``InitHits``. The device banded-DP rejection filter (K2) is
not part of this slice: every candidate is extended on the host, as the
JAX package does below its 2000-candidate threshold.
"""
from __future__ import annotations

import numpy as np

from gblastn_tpu.gapped.dynprog import dyn_prog_nt_gapped_alignment
from gblastn_tpu.gapped.greedy import greedy_gapped_alignment
from gblastn_tpu.hits import (
    HSP,
    HSPList,
    ContainmentIndex,
    adjust_odd_scores,
    get_evalues,
    purge_common_endpoints,
    reap_by_evalue,
    sort_by_score,
)
from gblastn_tpu.io.query import QueryBlock
from gblastn_tpu.params.derived import SearchParams
from gblastn_tpu.params.options import ExtensionMethod
from gblastn_tpu.stats.karlin import nucl_score_matrix
from gblastn_tpu.utils.profiling import slog
from gblastn_tpu_torch.engine.seeding import InitHits


def _walk_native(
    qblock: QueryBlock,
    subject2: np.ndarray,
    subject_start: int,
    init_order: np.ndarray,
    init: InitHits,
    params: SearchParams,
) -> list[HSP] | None:
    """native/prelim.cpp fast path for the per-subject walk; None = use
    the Python loop (identical semantics)."""
    from gblastn_tpu.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    opts = params.options
    order = np.asarray(init_order, np.int64)
    n = len(order)
    if n == 0:
        return []
    ctx = np.ascontiguousarray(np.asarray(init.context)[order], np.int32)
    uq = np.ascontiguousarray(np.asarray(init.q_start)[order], np.int64)
    us = np.ascontiguousarray(
        np.asarray(init.s_start)[order].astype(np.int64) - subject_start
    )
    ln = np.ascontiguousarray(np.asarray(init.length)[order], np.int64)
    sc = np.ascontiguousarray(np.asarray(init.score)[order], np.int64)
    qo = np.ascontiguousarray(np.asarray(init.q_off)[order], np.int64)
    so = np.ascontiguousarray(
        np.asarray(init.s_off)[order].astype(np.int64) - subject_start
    )
    ctx_off = np.ascontiguousarray(
        qblock.context_offsets()[:-1], np.int64
    )
    ctx_len = np.ascontiguousarray(
        [c.length for c in qblock.contexts], np.int64
    )
    cutoff = np.ascontiguousarray(
        [c.cutoff_score for c in params.contexts], np.int64
    )
    greedy = opts.extension_method is ExtensionMethod.GREEDY
    mat_ptr = 0
    if not greedy:
        mat = np.ascontiguousarray(
            nucl_score_matrix(opts.reward, opts.penalty), np.int32
        )
        mat_ptr = mat.ctypes.data
    sub = np.ascontiguousarray(subject2, np.uint8)
    qbuf = np.ascontiguousarray(qblock.buffer, np.uint8)
    o_qo = np.empty(n, np.int64)
    o_qe = np.empty(n, np.int64)
    o_so = np.empty(n, np.int64)
    o_se = np.empty(n, np.int64)
    o_sc = np.empty(n, np.int64)
    o_cx = np.empty(n, np.int32)
    o_qg = np.empty(n, np.int64)
    o_sg = np.empty(n, np.int64)
    n_ext = np.zeros(1, np.int64)
    k = lib.gblastn_gapped_prelim_walk(
        qbuf.ctypes.data, len(qbuf), sub.ctypes.data, len(sub),
        n, ctx.ctypes.data, uq.ctypes.data, us.ctypes.data,
        ln.ctypes.data, sc.ctypes.data, qo.ctypes.data, so.ctypes.data,
        0, ctx_off.ctypes.data, ctx_len.ctypes.data,
        cutoff.ctypes.data, 0 if greedy else 1,
        opts.reward, opts.penalty, opts.gap_open, opts.gap_extend,
        params.gap_x_dropoff, opts.min_diag_separation, mat_ptr,
        o_qo.ctypes.data, o_qe.ctypes.data, o_so.ctypes.data,
        o_se.ctypes.data, o_sc.ctypes.data, o_cx.ctypes.data,
        o_qg.ctypes.data, o_sg.ctypes.data, n_ext.ctypes.data,
    )
    if k < 0:
        return None
    slog.diagnostics.gapped_extensions += int(n_ext[0])
    saved: list[HSP] = []
    for j in range(int(k)):
        c = int(o_cx[j])
        saved.append(HSP(
            q_off=int(o_qo[j]), q_end=int(o_qe[j]),
            s_off=int(o_so[j]), s_end=int(o_se[j]),
            score=int(o_sc[j]), context=c,
            q_frame=qblock.contexts[c].frame, s_frame=1,
            q_gapped_start=int(o_qg[j]), s_gapped_start=int(o_sg[j]),
        ))
    return saved


def get_gapped_score_one_subject(
    qblock: QueryBlock,
    subject2: np.ndarray,          # uint8[s_len] 2-bit codes of one subject
    subject_start: int,            # base offset of this subject in the DB
    init_order: np.ndarray,        # indices into init (score order)
    init: InitHits,
    params: SearchParams,
    use_native: bool | None = None,
) -> list[HSP]:
    """BLAST_GetGappedScore (blast_gapalign.c:3233), greedy and DP
    branches."""
    opts = params.options
    if use_native is not False:
        res = _walk_native(
            qblock, subject2, subject_start, init_order, init, params,
        )
        if res is not None:
            return res
    saved: list[HSP] = []
    index = ContainmentIndex(
        opts.min_diag_separation, q_span=len(qblock.buffer) + 1
    )
    n_extensions = 0
    ctx_offsets = qblock.context_offsets()
    matrix = (
        nucl_score_matrix(opts.reward, opts.penalty)
        if opts.extension_method is not ExtensionMethod.GREEDY else None
    )

    for i in init_order:
        ctx = int(init.context[i])
        ctx_info = qblock.contexts[ctx]
        q0 = int(ctx_offsets[ctx])
        q_len = ctx_info.length
        # ungapped data in context-local / subject-local coordinates
        uq_start = int(init.q_start[i]) - q0
        us_start = int(init.s_start[i]) - subject_start
        length = int(init.length[i])
        score = int(init.score[i])

        if index.contains(
            uq_start, uq_start + length, us_start, us_start + length,
            score, ctx,
        ):
            continue

        cutoff = params.contexts[ctx].cutoff_score
        query = qblock.buffer[q0: q0 + q_len]
        n_extensions += 1
        if opts.extension_method is ExtensionMethod.GREEDY:
            # greedy seed: middle of the ungapped alignment
            # (blast_gapalign.c:3466-3471)
            q_off = uq_start + length // 2
            s_off = us_start + length // 2
            res = greedy_gapped_alignment(
                query, subject2, params.gap_x_dropoff,
                opts.reward, opts.penalty, opts.gap_open, opts.gap_extend,
                q_off, s_off, do_traceback=False,
            )
        else:
            # DP path: start inside the first all-match byte of the seed
            # (blast_gapalign.c:3486-3499)
            q_off = int(init.q_off[i]) - q0
            s_off = int(init.s_off[i]) - subject_start
            if us_start + length >= s_off + 8:
                q_off += 3
                s_off += 3
            res = dyn_prog_nt_gapped_alignment(
                query, subject2, matrix,
                opts.gap_open, opts.gap_extend, params.gap_x_dropoff,
                q_off, s_off,
            )
        if res.score >= cutoff:
            h = HSP(
                q_off=res.q_start, q_end=res.q_end,
                s_off=res.s_start, s_end=res.s_end,
                score=res.score, context=ctx,
                q_frame=ctx_info.frame, s_frame=1,
                q_gapped_start=res.q_seed_start,
                s_gapped_start=res.s_seed_start,
            )
            saved.append(h)
            index.add(h)
    slog.diagnostics.gapped_extensions += n_extensions
    return saved


def run_gapped_prelim(
    init: InitHits,
    qblock: QueryBlock,
    get_subject2,                  # fn(oid) -> uint8[s_len] 2-bit codes
    subject_starts: np.ndarray,    # int64[num_seqs] DB base offsets
    params: SearchParams,
) -> list[HSPList]:
    """Prelim gapped stage over all subjects with init hits.

    ``init`` must be in final score order (run_seeding output). Returns
    per-oid HSPLists sorted by score, with e-values assigned and reaped
    (blast_engine.c:503-509 and :792-812)."""
    eff_searchsp = {
        c: params.contexts[c].eff_searchsp
        for c in range(len(params.contexts))
    }
    out: list[HSPList] = []
    if len(init) == 0:
        return out
    oids = np.asarray(init.oid)
    for oid in np.unique(oids):
        order = np.flatnonzero(oids == oid)
        subject2 = get_subject2(int(oid))
        hsps = get_gapped_score_one_subject(
            qblock, subject2, int(subject_starts[oid]), order, init,
            params,
        )
        if not hsps:
            continue
        hsps = purge_common_endpoints(hsps, purge=True)
        adjust_odd_scores(hsps, params.round_down)
        sort_by_score(hsps)
        lst = HSPList(oid=int(oid), hsps=hsps)
        get_evalues(lst, params.kbp_gap, eff_searchsp)
        reap_by_evalue(lst, params.options.evalue)
        if lst.hsps:
            lst.best_evalue = min(h.evalue for h in lst.hsps)
            out.append(lst)
    return out
