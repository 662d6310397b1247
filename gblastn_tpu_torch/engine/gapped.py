"""Preliminary gapped extension stage (host walk + device filter).

The port's counterpart of ``gblastn_tpu/engine/gapped.py``: the host walk
(``BLAST_GetGappedScore``, NCBI blast_gapalign.c:3233, and the
per-subject post-processing of blast_engine.c:503-509, :792-812), taking
the port's ``InitHits``, and in front of it the device banded-DP
rejection filter (K2, ops.gapped): every candidate of a batch is scored
on the device in one launch, and the walk skips extending the candidates
whose flag-free band score, plus a margin, misses the cutoff. Admitted
candidates are extended exactly on the host, so the saved HSPs are those
of the host-only walk.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gblastn_tpu_torch.gapped.dynprog import dyn_prog_nt_gapped_alignment
from gblastn_tpu_torch.gapped.greedy import greedy_gapped_alignment
from gblastn_tpu_torch.hits import (
    HSP,
    HSPList,
    ContainmentIndex,
    adjust_odd_scores,
    get_evalues,
    purge_common_endpoints,
    reap_by_evalue,
    sort_by_score,
)
from gblastn_tpu_torch.engine.seeding import InitHits
from gblastn_tpu_torch.io.query import QueryBlock
from gblastn_tpu_torch.ops.gapped import (
    NEG,
    banded_gapped_scores,
    check_jobs,
    fold_directions,
    gapped_jobs,
)
from gblastn_tpu_torch.params.derived import SearchParams
from gblastn_tpu_torch.params.options import ExtensionMethod
from gblastn_tpu_torch.stats.karlin import nucl_score_matrix
from gblastn_tpu_torch.utils.profiling import slog


@dataclass
class DeviceGappedData:
    """Device banded-DP rejection filter context (ops.gapped).

    ``dbl`` is the score scale the kernel runs in relative to the host
    aligner's reported scores (2 when the host greedy works in doubled
    units, else 1). The query and subject are the batch's BLASTNA bytes
    and the resident 2-bit codes, read in place."""

    query: torch.Tensor            # uint8[Q] BLASTNA codes on the device
    subject2: torch.Tensor         # int8[S] resident 2-bit codes
    matrix16: torch.Tensor         # int32[16, 4] kernel-scale matrix
    rows: int
    dbl: int
    gap_open: int                  # kernel scale
    gap_extend: int
    x_drop: int                    # kernel scale


def device_gapped_params(opts, gap_x_dropoff: int):
    """(matrix16, dbl, gap_open, gap_extend, x_drop) for the kernel's
    score scale, mirroring the host aligner drivers
    (gapped.greedy.greedy_gapped_alignment scale conversions and
    gapped.dynprog.dyn_prog_nt_gapped_alignment)."""
    r, p = opts.reward, opts.penalty
    if opts.extension_method is ExtensionMethod.GREEDY:
        if opts.gap_open == 0 and opts.gap_extend == 0:
            # non-affine greedy == affine DP at (2r, 2p, open 0,
            # extend r - 2p) in doubled units
            dbl, go, ge = 2, 0, r - 2 * p
        elif r % 2 == 1:
            dbl, go, ge = 2, 2 * opts.gap_open, 2 * opts.gap_extend
        else:
            dbl, go, ge = 1, opts.gap_open, opts.gap_extend
        # greedy match semantics: code < 4 and equal, else mismatch
        m = np.full((16, 4), dbl * p, np.int32)
        for c in range(4):
            m[c, c] = dbl * r
        m[15, :] = NEG
        return m, dbl, go, ge, dbl * gap_x_dropoff
    m = np.asarray(nucl_score_matrix(r, p), np.int32)[:16, :4]
    return m, 1, opts.gap_open, opts.gap_extend, gap_x_dropoff


def build_device_gapped(
    params: SearchParams,
    query: torch.Tensor,           # uint8[Q] the batch's query bytes
    subject2: torch.Tensor,        # int8[S] resident codes, same device
    rows: int,
) -> DeviceGappedData:
    opts = params.options
    matrix, dbl, go, ge, xd = device_gapped_params(
        opts, params.gap_x_dropoff
    )
    return DeviceGappedData(
        query=query, subject2=subject2,
        matrix16=torch.from_numpy(np.ascontiguousarray(matrix)).to(
            query.device),
        rows=rows, dbl=dbl, gap_open=go, gap_extend=ge, x_drop=int(xd),
    )


def gapped_filter_jobs(
    init: InitHits,
    qblock: QueryBlock,
    subject_starts: np.ndarray,
    subject_lengths: np.ndarray,
    params: SearchParams,
    dgd: DeviceGappedData,
):
    """K2's jobs for every candidate, on the filter's device: the seed
    point each host aligner would start from, the candidate's query
    context and subject as bounds, the kernel-scale X-drop."""
    n = len(init)
    opts = params.options
    ctx = np.asarray(init.context, np.int64)
    ctx_off = qblock.context_offsets().astype(np.int64)
    ctx_len = np.array(
        [c.length for c in qblock.contexts], np.int64
    )
    q_lo = ctx_off[ctx]
    q_hi = q_lo + ctx_len[ctx]
    oid = np.asarray(init.oid, np.int64)
    s_lo = np.asarray(subject_starts, np.int64)[oid]
    s_hi = s_lo + np.asarray(subject_lengths, np.int64)[oid]

    if opts.extension_method is ExtensionMethod.GREEDY:
        # greedy seeds at the middle of the ungapped alignment
        # (blast_gapalign.c:3466-3471)
        q_seed = np.asarray(init.q_start, np.int64) + (
            np.asarray(init.length, np.int64) // 2
        )
        s_seed = np.asarray(init.s_start, np.int64) + (
            np.asarray(init.length, np.int64) // 2
        )
    else:
        # DP split point: the byte-boundary adjustment of
        # s_BlastDynProgNtGappedAlignment (blast_gapalign.c:2762) on
        # top of the first-all-match-byte start selection (:3486-3499)
        q_off = np.asarray(init.q_off, np.int64).copy()
        s_off = np.asarray(init.s_off, np.int64).copy()
        us = np.asarray(init.s_start, np.int64)
        ln = np.asarray(init.length, np.int64)
        adj3 = us + ln >= s_off + 8
        q_off[adj3] += 3
        s_off[adj3] += 3
        s_loc = s_off - s_lo
        adjust = 4 - (s_loc % 4)
        q_seed = q_off + adjust
        s_seed = s_off + adjust
        over = (q_seed > q_hi) | (s_seed > s_hi)
        q_seed[over] -= 4
        s_seed[over] -= 4

    # built and range-checked on the host, then moved in one copy: the
    # kernel's launch reads nothing back from the card
    seeds = torch.from_numpy(np.stack([q_seed, s_seed, q_lo, q_hi, s_lo,
                                       s_hi]))
    jobs = gapped_jobs(*seeds, torch.full((n,), dgd.x_drop,
                                          dtype=torch.int32))
    jobs = check_jobs(jobs, dgd.query.numel(), dgd.subject2.numel(),
                      dgd.rows)
    return jobs.to(dgd.query.device)


def device_gapped_rejects(
    init: InitHits,
    qblock: QueryBlock,
    subject_starts: np.ndarray,
    subject_lengths: np.ndarray,
    params: SearchParams,
    dgd: DeviceGappedData,
) -> np.ndarray:
    """bool[n] mask of candidates the banded device DP certifies can
    NOT reach their context cutoff (flag-free band score + margin below
    cutoff); the host walk skips extending these. Admitted candidates
    are still extended exactly on host, so saved HSPs are identical to
    the host-only path."""
    jobs = gapped_filter_jobs(init, qblock, subject_starts,
                              subject_lengths, params, dgd)
    score, flags = banded_gapped_scores(
        dgd.query, dgd.subject2, dgd.matrix16, jobs, rows=dgd.rows,
        gap_open=dgd.gap_open, gap_extend=dgd.gap_extend,
    )
    total, flags = fold_directions(score, flags, jobs.n_right)
    cutoff = torch.from_numpy(np.array(
        [c.cutoff_score for c in params.contexts], np.int64
    )[np.asarray(init.context, np.int64)]).to(total.device)
    # the margin, 16*dbl: the X-drop schedule differences (lazy per-row
    # vs greedy's distance-delayed test) underestimate the host score by
    # <= 10 doubled units over 1500 adversarial trials, so 16*dbl gives
    # 3x headroom (tests/test_gapped_device.py measures this). Any less
    # and the filter could reject a candidate the host walk saves.
    margin = 16 * dgd.dbl
    reject = ((flags == 0) & (total < dgd.dbl * cutoff - margin)).cpu()
    reject = reject.numpy()
    slog.diagnostics.device_gapped_rejects += int(reject.sum())
    return reject


def _walk_native(
    qblock: QueryBlock,
    subject2: np.ndarray,
    subject_start: int,
    init_order: np.ndarray,
    init: InitHits,
    params: SearchParams,
    reject: np.ndarray | None,
) -> list[HSP] | None:
    """native/prelim.cpp fast path for the per-subject walk; None = use
    the Python loop (identical semantics)."""
    from gblastn_tpu_torch.native import get_lib

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
    rej_ptr = 0
    if reject is not None:
        rej = np.ascontiguousarray(
            np.asarray(reject)[order].astype(np.uint8)
        )
        rej_ptr = rej.ctypes.data
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
        rej_ptr, ctx_off.ctypes.data, ctx_len.ctypes.data,
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
    reject: np.ndarray | None = None,   # device filter verdicts (global)
    use_native: bool | None = None,
) -> list[HSP]:
    """BLAST_GetGappedScore (blast_gapalign.c:3233), greedy and DP
    branches."""
    opts = params.options
    if use_native is not False:
        res = _walk_native(
            qblock, subject2, subject_start, init_order, init, params,
            reject,
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

        if reject is not None and reject[i]:
            # the device band DP certified this extension cannot reach
            # the cutoff; a rejected extension saves nothing and adds
            # nothing to the containment index, so the walk is
            # host-identical
            n_extensions += 1
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
    device_gapped: DeviceGappedData | None = None,
    subject_lengths: np.ndarray | None = None,
) -> list[HSPList]:
    """Prelim gapped stage over all subjects with init hits.

    ``init`` must be in final score order (run_seeding output). Returns
    per-oid HSPLists sorted by score, with e-values assigned and reaped
    (blast_engine.c:503-509 and :792-812). With ``device_gapped`` the
    banded-DP kernel pre-screens every candidate in one launch and the
    host only extends the survivors."""
    eff_searchsp = {
        c: params.contexts[c].eff_searchsp
        for c in range(len(params.contexts))
    }
    out: list[HSPList] = []
    if len(init) == 0:
        return out
    reject = None
    if device_gapped is not None and subject_lengths is not None:
        with slog.time("device.gapped_filter"):
            reject = device_gapped_rejects(
                init, qblock, subject_starts, subject_lengths,
                params, device_gapped,
            )
    oids = np.asarray(init.oid)
    for oid in np.unique(oids):
        order = np.flatnonzero(oids == oid)
        subject2 = get_subject2(int(oid))
        hsps = get_gapped_score_one_subject(
            qblock, subject2, int(subject_starts[oid]), order, init,
            params, reject,
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
