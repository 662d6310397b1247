"""K1, the ungapped X-drop extension: wrapper, plain version, tables.

The port's counterpart of ``gblastn_tpu/ops/pallas_ungapped.py``. The
kernel itself is ``csrc/ungapped_xdrop.cu`` (one thread per seed, no
window); ``ungapped_extend_window_ref`` is its plain PyTorch version with
the same semantics, and ``ungapped_extend_window`` dispatches on where
the tensors live: CPU tensors go to the plain version, CUDA tensors to
the kernel (or an exception). There is no fallback between the two.

Semantics (s_NuclUngappedExtendExact, NCBI na_ungapped.c:152): for each
seed, a left walk over q_off-1, q_off-2, ... and a right walk over
q_off, q_off+1, ...; steps past the seed's budget max_l / max_r score
NEG_BIG; a walk stops at the first step whose running sum falls below
max(best so far, 0) - x, and best moves only on a strictly greater sum.
Returns int32 (q_start, s_start, length, score, flags) with flags bit 1 /
bit 2 set when the left / right walk ended at its budget.
"""
from __future__ import annotations

import numpy as np
import torch

from gblastn_tpu_torch.io.encoding import BLASTNA_TO_NCBI4NA

NEG_BIG = -(1 << 24)
_CHUNK = 128          # plain version: steps scored per loop iteration


def make_table64(matrix16: np.ndarray) -> np.ndarray:
    """(q*4+s) code table + closed-form score constants.

    Entries [0:64] hold the flattened BLASTNA x 2na table; [64:72] hold
    [reward, penalty, amb_deg2, amb_deg3, amb_deg4, sentinel, 0, 0]. The
    kernel scores with the closed form (the nucleotide matrix depends
    only on exact/member/degeneracy -- checked here)."""
    m = np.asarray(matrix16, dtype=np.int64)[:16, :4]
    table = np.clip(m.reshape(-1), NEG_BIG, None).astype(np.int32)
    consts = np.zeros(8, dtype=np.int32)
    consts[0] = table[0]           # reward  (A vs A)
    consts[1] = table[1]           # penalty (A vs C)
    consts[2] = table[4 * 4 + 0]   # amb deg2 member (R vs A)
    consts[3] = table[10 * 4 + 1]  # amb deg3 member (B vs C)
    consts[4] = table[14 * 4 + 0]  # amb deg4 member (N vs A)
    consts[5] = table[15 * 4 + 0]  # sentinel
    for q in range(16):
        mask = int(BLASTNA_TO_NCBI4NA[q]) if q != 15 else 0
        deg = bin(mask).count("1")
        for s in range(4):
            if mask == 0:
                want = consts[5]
            elif mask == (1 << s):
                want = consts[0]
            elif mask & (1 << s):
                want = consts[deg]    # deg 2/3/4 -> consts[2]/[3]/[4]
            else:
                want = consts[1]
            if table[q * 4 + s] != want:
                raise ValueError(
                    f"score matrix has no closed form at ({q}, {s})"
                )
    return np.concatenate([table, consts])


def _make_query_pack_table() -> np.ndarray:
    """BLASTNA code -> packed (4na mask | degeneracy << 4); sentinel 0."""
    t = np.zeros(256, dtype=np.uint8)
    for q in range(16):
        mask = int(BLASTNA_TO_NCBI4NA[q]) if q != 15 else 0
        deg = bin(mask).count("1")
        t[q] = mask | (deg << 4)
    return t


QUERY_PACK = _make_query_pack_table()


def pack_query(query: torch.Tensor) -> torch.Tensor:
    """uint8 BLASTNA codes -> the kernel's packed query bytes."""
    table = torch.from_numpy(QUERY_PACK).to(query.device)
    return table[query.long()]


def _scores(qp: torch.Tensor, scode: torch.Tensor, c: list[int]):
    """Closed-form score of packed query bytes against 2-bit codes
    (c = table64[64:70])."""
    qmask = qp & 15
    deg = qp >> 4
    sbit = torch.ones_like(scode) << scode.clamp(0, 3)
    member = (qmask & sbit) != 0
    exact = qmask == sbit
    amb = torch.where(deg == 2, c[2], torch.where(deg == 3, c[3], c[4]))
    return torch.where(
        qmask == 0, c[5],
        torch.where(exact, c[0], torch.where(member, amb, c[1])),
    )


def _walk_ref(query, subject, q0, s0, left, max_steps, x, table):
    """(best, best_pos, stop_step) of one direction for every seed, in
    int64, scoring _CHUNK steps per iteration until every walk stopped
    (each one does: the step past its budget scores NEG_BIG). ``table``
    is the closed-form score of (packed query byte * 4 + subject code)."""
    n = q0.shape[0]
    dev = q0.device
    Q, S = query.shape[0], subject.shape[0]
    best = torch.zeros(n, dtype=torch.int64, device=dev)
    pos = torch.zeros_like(best)
    stop = torch.zeros_like(best)
    run = torch.zeros_like(best)
    act = torch.arange(n, device=dev)
    steps = torch.arange(1, _CHUNK + 1, device=dev)
    base = 0
    # the live seeds' own arrays, compacted with ``act``
    qa, sa, ma, xa = q0, s0, max_steps, x
    while act.numel():
        j = base + steps                                   # [K]
        off = -j if left else j - 1
        qi = (qa[:, None] + off).clamp_(0, Q - 1)
        si = (sa[:, None] + off).clamp_(0, S - 1)
        sc = table[query[qi].long() * 4 + subject[si].long().clamp_(0, 3)]
        sc.masked_fill_(j[None, :] > ma[:, None], NEG_BIG)
        cs = torch.cumsum(sc, dim=1).add_(run[act, None])
        b0 = best[act]
        prev = torch.cat([b0[:, None], torch.maximum(
            b0[:, None], torch.cummax(cs, dim=1).values[:, :-1])], dim=1)
        dropped = cs < prev - xa[:, None]
        any_d = dropped.any(dim=1)
        first = torch.where(
            any_d, torch.argmax(dropped.to(torch.int32), dim=1), _CHUNK
        )
        # steps before the drop; the dropping step cannot raise the best
        live = steps[None, :] - 1 < first[:, None]
        cand = cs.masked_fill(~live, torch.iinfo(torch.int64).min)
        cb = cand.max(dim=1).values
        # the first step reaching it: best moves only on a greater sum
        cpos = torch.argmax((cand == cb[:, None]).to(torch.int32), dim=1)
        up = cb > b0
        best[act] = torch.where(up, cb, b0)
        pos[act] = torch.where(up, base + cpos + 1, pos[act])
        stop[act[any_d]] = base + first[any_d] + 1
        run[act] = cs[:, -1]
        keep = ~any_d
        act, qa, sa, ma, xa = (t[keep] for t in (act, qa, sa, ma, xa))
        base += _CHUNK
    return best, pos, stop


def ungapped_extend_window_ref(query_packed, subject2, table64, q_off,
                               s_off, x_drop, max_l, max_r,
                               return_steps: bool = False):
    """Plain PyTorch version of K1 (same arguments and results as
    ``ungapped_extend_window``). With ``return_steps`` it also returns
    the steps each seed's two walks scored (int64[n]), the work count
    behind K1's bound."""
    c = [int(v) for v in table64[64:70].tolist()]
    codes = torch.arange(256, device=q_off.device)
    table = _scores(codes[:, None], torch.arange(4, device=q_off.device),
                    c).reshape(-1)
    q0 = q_off.long()
    s0 = s_off.long()
    x = x_drop.long()
    ml = max_l.long()
    mr = max_r.long()
    l_best, l_pos, l_stop = _walk_ref(query_packed, subject2, q0, s0,
                                      True, ml, x, table)
    r_best, r_pos, r_stop = _walk_ref(query_packed, subject2, q0, s0,
                                      False, mr, x, table)
    flags = 2 * (l_stop > ml).long() + 4 * (r_stop > mr).long()
    outs = (q0 - l_pos, s0 - l_pos, l_pos + r_pos, l_best + r_best, flags)
    outs = tuple(o.to(torch.int32) for o in outs)
    if return_steps:
        return outs + (l_stop + r_stop,)
    return outs


def _check_kernel_args(query_packed, subject2, table64, seeds):
    dev = query_packed.device
    for name, t, dt in (("query_packed", query_packed, torch.uint8),
                        ("subject2", subject2, torch.int8),
                        ("table64", table64, torch.int32)):
        if t.device != dev or t.dtype != dt or t.dim() != 1:
            raise ValueError(f"{name}: want 1-D {dt} on {dev}, got "
                             f"{t.dim()}-D {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table64.numel() < 72:
        raise ValueError("table64 must hold 72 entries (make_table64)")
    n = seeds[0].numel()
    if n >= 2**31:
        raise ValueError("too many seeds for one launch")
    for t in seeds:
        if (t.device != dev or t.dtype != torch.int32 or t.dim() != 1
                or t.numel() != n or not t.is_contiguous()):
            raise ValueError(
                f"seed arrays must be contiguous 1-D int32 of length {n} "
                f"on {dev}"
            )
    q_off, s_off, _x, max_l, max_r = (t.long() for t in seeds)
    if n and bool(
        (max_l.min() < 0) | (max_r.min() < 0)
        | ((q_off - max_l).min() < 0) | ((s_off - max_l).min() < 0)
        | ((q_off + max_r).max() > query_packed.numel())
        | ((s_off + max_r).max() > subject2.numel())
    ):
        raise ValueError("a walk budget reaches outside query or subject")


def ungapped_extend_window(query_packed, subject2, table64, q_off, s_off,
                           x_drop, max_l, max_r):
    """K1: exact two-way X-drop ungapped extension of every seed.

    query_packed uint8[Q] (``pack_query``), subject2 int8[S] 2-bit codes,
    table64 int32[72] (``make_table64``), and int32[n] q_off, s_off,
    x_drop, max_l, max_r. CPU tensors run the plain version; CUDA tensors
    launch the kernel on the current stream (and count the launch in
    ``ungapped_extend_window.launches``)."""
    seeds = (q_off, s_off, x_drop, max_l, max_r)
    tensors = (query_packed, subject2, table64) + seeds
    if all(t.device.type == "cpu" for t in tensors):
        return ungapped_extend_window_ref(query_packed, subject2, table64,
                                          *seeds)
    _check_kernel_args(query_packed, subject2, table64, seeds)
    dev = query_packed.device
    if dev.type != "cuda":
        raise ValueError(f"ungapped_extend_window: no kernel for {dev}")
    from gblastn_tpu_torch.ops import _build

    n = q_off.numel()
    outs = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                 for _ in range(5))
    if n == 0:
        return outs
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gblastn_ungapped_xdrop(
            *(t.data_ptr() for t in tensors), n,
            *(o.data_ptr() for o in outs), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ungapped_xdrop launch failed: CUDA error {rc}")
    ungapped_extend_window.launches += 1
    return outs


ungapped_extend_window.launches = 0
