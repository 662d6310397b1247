"""K1, the ungapped X-drop extension: wrapper, plain version, tables.

The port's counterpart of ``gblastn_tpu/ops/pallas_ungapped.py``. The
kernel itself is ``csrc/ungapped_xdrop.cu`` (no window; a thread a
seed); ``ungapped_extend_window_ref`` is its plain PyTorch version with
the same semantics, and ``ungapped_extend_window`` dispatches on where
the tensors live: CPU tensors go to the plain version, CUDA tensors to
the kernel (or an exception). There is no fallback between the two.

Semantics (s_NuclUngappedExtendExact, NCBI na_ungapped.c:152): for each
seed, a left walk over q_off-1, q_off-2, ... and a right walk over
q_off, q_off+1, ...; steps past the seed's budget max_l / max_r score
NEG_BIG; a walk stops at the first step whose running sum falls below
max(best so far, 0) - x, and best moves only on a strictly greater sum.
Returns (q_start, s_start, length, score, flags), s_start int64 and the
rest int32, with flags bit 1 / bit 2 set when the left / right walk
ended at its budget. Subject offsets are int64 throughout (a resident
database past 2^31 bases); query offsets, budgets and scores are int32.

Ranges: every seed needs max_l, max_r >= 0, q_off - max_l >= 0, s_off -
max_l >= 0, q_off + max_r <= Q and s_off + max_r <= S; the plain path
raises ValueError at once. The kernel also needs 0 <= x_drop < X_LIMIT
(so that every NEG_BIG step ends a walk in int32). It checks each seed
itself, so that a launch waits on nothing, and marks a seed out of range
with FLAG_RANGE (no walk); ``check_flags`` raises ValueError where the
caller fetches the flags.
"""
from __future__ import annotations

import numpy as np
import torch

from gblastn_tpu_torch.io.encoding import BLASTNA_TO_NCBI4NA

NEG_BIG = -(1 << 24)
X_LIMIT = 1 << 23     # the kernel's x_drop < X_LIMIT: NEG_BIG ends a walk
FLAG_RANGE = 8        # the kernel: the seed's budgets or x_drop out of range
RANGE_ERROR = "a walk budget reaches outside query or subject"
FLAG_ERROR = RANGE_ERROR + ", or an x_drop is outside the kernel's [0, 2^23)"
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


def score_table(table64, device=None) -> torch.Tensor:
    """int32[1024] score of (packed query byte << 2) | subject code 0..3:
    the plain version's table, and the table each block of the kernel
    builds in shared memory from the same constants (table64[64:70])."""
    c = [int(v) for v in table64[64:70].tolist()]
    codes = torch.arange(256, device=device)
    return _scores(codes[:, None], torch.arange(4, device=device),
                   c).reshape(-1).to(torch.int32)


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
    the steps each seed's left and right walk scored, the dropping step
    included (int64[2, n]): the work count behind K1's bound."""
    table = score_table(table64, q_off.device).long()
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
    i32 = torch.int32
    outs = ((q0 - l_pos).to(i32), s0 - l_pos, (l_pos + r_pos).to(i32),
            (l_best + r_best).to(i32), flags.to(i32))
    if return_steps:
        return outs + (torch.stack([l_stop, r_stop]),)
    return outs


def lockstep_lane_steps(steps: torch.Tensor) -> int:
    """A model of the lane-steps the kernel's lockstep warps run for walks
    of ``steps`` (int64[2, n], left and right, the dropping step included,
    as ``ungapped_extend_window_ref(..., return_steps=True)`` gives them):
    32 x the longest left + right of each warp of 32 seeds in launch
    order. Against the walk steps, the share of lanes busy. Counted from
    the plain version's steps, not on the card."""
    tot = steps.sum(0)
    pad = (-tot.numel()) % 32
    tot = torch.cat([tot, tot.new_zeros(pad)]).view(-1, 32)
    return int(tot.max(1).values.sum()) * 32


def check_ranges(Q: int, S: int, q_off, s_off, x_drop, max_l, max_r):
    """ValueError unless every seed's budgets stay inside a query of Q
    and a subject of S bytes. The plain path's check; the kernel checks
    the same per seed, and its x_drop range too (FLAG_RANGE)."""
    if not q_off.numel():
        return
    q, s, ml, mr = (t.long() for t in (q_off, s_off, max_l, max_r))
    if bool((ml < 0).any() | (mr < 0).any() | ((q - ml) < 0).any()
            | ((s - ml) < 0).any() | ((q + mr) > Q).any()
            | ((s + mr) > S).any()):
        raise ValueError(RANGE_ERROR)


def check_flags(flags) -> None:
    """ValueError if the kernel marked a seed out of range (FLAG_RANGE).
    ``flags`` is K1's flags output, or a numpy copy of it: a CUDA tensor
    is fetched, which waits on the card; the search path checks the
    copy it fetches anyway."""
    f = flags.cpu().numpy() if isinstance(flags, torch.Tensor) else flags
    if (np.asarray(f) & FLAG_RANGE).any():
        raise ValueError(FLAG_ERROR)


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
    if query_packed.numel() >= 2**31:
        raise ValueError("query too long for 32-bit offsets")
    n = seeds[0].numel()
    if n >= 2**31:
        raise ValueError("too many seeds for one launch")
    for k, t in enumerate(seeds):
        dt = torch.int64 if k == 1 else torch.int32
        if (t.device != dev or t.dtype != dt or t.dim() != 1
                or t.numel() != n or not t.is_contiguous()):
            raise ValueError(
                f"seed arrays must be contiguous 1-D of length {n} on "
                f"{dev}, s_off int64 and the rest int32"
            )


_lib_fns = None


def _bind():
    """The kernel's entry point and PyTorch's raw-stream and capture
    queries, bound once."""
    global _lib_fns
    if _lib_fns is None:
        from gblastn_tpu_torch.ops import _build

        _lib_fns = (_build.load().gblastn_ungapped_xdrop,
                    torch._C._cuda_getCurrentRawStream,
                    torch._C._cuda_isCurrentStreamCapturing)
    return _lib_fns


def ungapped_extend_window(query_packed, subject2, table64, q_off, s_off,
                           x_drop, max_l, max_r):
    """K1: exact two-way X-drop ungapped extension of every seed.

    query_packed uint8[Q] (``pack_query``), subject2 int8[S] 2-bit codes,
    table64 int32[72] (``make_table64``), and [n] q_off, s_off, x_drop,
    max_l, max_r: s_off int64 (any integer type on the CPU), the rest
    int32. Returns int32 q_start, int64 s_start and int32 length, score
    and flags. CPU tensors run the plain version (after
    ``check_ranges``). CUDA tensors launch the kernel on the current
    stream without waiting on the card, so a CUDA graph can capture the
    call; a seed out of range comes back with FLAG_RANGE, which
    ``check_flags`` turns into a ValueError. The launch counts in
    ``ungapped_extend_window.launches``, or, while the stream captures a
    graph, in ``ungapped_extend_window.captured`` (whoever replays the
    graph adds it to ``launches`` at each replay, as
    ``tools.timing.graph_ms`` does)."""
    seeds = (q_off, s_off, x_drop, max_l, max_r)
    tensors = (query_packed, subject2, table64) + seeds
    if all(t.device.type == "cpu" for t in tensors):
        check_ranges(query_packed.numel(), subject2.numel(), *seeds)
        return ungapped_extend_window_ref(query_packed, subject2, table64,
                                          *seeds)
    _check_kernel_args(query_packed, subject2, table64, seeds)
    dev = query_packed.device
    if dev.type != "cuda":
        raise ValueError(f"ungapped_extend_window: no kernel for {dev}")
    n = q_off.numel()
    # the int32 outputs as rows of one allocation, and s_start
    q, length, score, flags = torch.empty((4, n), dtype=torch.int32,
                                          device=dev).unbind(0)
    outs = (q, torch.empty(n, dtype=torch.int64, device=dev), length, score,
            flags)
    if n == 0:
        return outs
    fn, raw_stream, capturing = _lib_fns or _bind()
    d = dev.index
    args = (*(t.data_ptr() for t in tensors), n, query_packed.numel(),
            subject2.numel(), *(o.data_ptr() for o in outs), raw_stream(d))
    if d == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(d):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"ungapped_xdrop launch failed: CUDA error {rc}")
    if capturing():
        ungapped_extend_window.captured += 1
    else:
        ungapped_extend_window.launches += 1
    return outs


ungapped_extend_window.launches = 0
ungapped_extend_window.captured = 0
