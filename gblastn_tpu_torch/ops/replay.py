"""The device finish of seeding: the double-word probe (RR), the
approximate-ungapped gate (G) and the per-diagonal replay (R), one-hit
and two-hit, wrappers and plain versions.

The port's counterpart of ``right_run_packed``, ``approx_gate_device``
and ``diag_replay_device`` in ``gblastn_tpu/ops/seeding.py``. The kernels
are ``csrc/right_run.cu``, ``csrc/approx_gate.cu`` and
``csrc/diag_replay.cu``; ``right_run_ref``, ``approx_gate_ref`` and
``diag_replay_ref`` are their plain PyTorch versions with the same
semantics. Each wrapper dispatches on where the tensors live: CPU tensors
go to the plain version, CUDA tensors to the kernel (or an exception).
There is no fallback between the two.

RR (``engine/seeding.py::compute_right_runs``; NCBI s_TypeOfWord,
na_ungapped.c:559-586): the exact-match run to the right of each seed's
word end, capped at the word size, read off the packed query nibbles and
subject words; a query nibble equal to ``1 << code`` is an unambiguous
equal base, and a sentinel, the query's end or the owning subject's end
stops the run. Two-hit seeding only, and only where the word is longer
than the lookup word of a contiguous template (the ``rr_zero`` rule).

G (s_NuclUngappedExtend, NCBI na_ungapped.c:263; host twin
``engine/approx.py::approx_ungapped_one``, unclamped): for every seed
whose exact K1 score meets its context's word cutoff, the reference's
approximate two-way walk, four bases a step off the packed subject
through the 256-entry XOR table, the running sum reset into the score
whenever it turns positive, stopping when it falls below -x_drop. A
seed whose approximate score misses the reduced cutoff is demoted: its
rows become the approximate extension, as ``_finish_init_hits`` writes
them. Every seed resolves: there is no clamp and no fallback.

A seed's demoted length counts from ``s + word + right_run``, the end of
its word and double word.

R (``engine/seeding.py::one_hit_diag_filter`` and
``two_hit_diag_filter``; NCBI s_BlastnDiagTableExtendInitialHit,
na_ungapped.c:612-755, scan range 0): seeds ordered by (oid, masked
diagonal, s, q, index); per (oid, masked diagonal) a seed starting
before ``last_hit`` is skipped. One-hit (window 0): a seed scoring at
least its cutoff is saved and moves ``last_hit`` to the end of its
extension, any other moves it to ``s + word``. Two-hit (window > 0):
the state is (last_hit, flag), a virgin diagonal starts at (-window,
0); a seed takes the first-hit branch when the flag is set or when
``s + word > last_hit + window``, and there its word end gains its right
run and it is ready only as a double word (run >= word); elsewhere (the
second hit within the window) it is ready. A ready seed scoring at least
its cutoff is saved and moves ``last_hit`` to its extension's end; any
other moves it to its word end. The flag is whether the seed was saved.

The kernels check their inputs per seed, so a launch waits on nothing: G
marks a seed whose walk would read outside the query or the packed
subject, or whose context or subject index is out of range, with
FLAG_RANGE (no walk; the exact rows stay); ``check_gate_flags`` raises
ValueError where the caller fetches the flags. R's inputs are the sort's
own, so it has nothing to check; the sort's key holds each field in the
bits its bound allows, and ``key_range_flag`` gives one int32 on the
seeds' device, nonzero where a field lies past its bound, which
``check_key_flag`` raises where the caller fetches it. RR reads only
inside the query and the owning subject, and a seed whose subject index
is out of range has a run of 0.
"""
from __future__ import annotations

import numpy as np
import torch

FLAG_NEED = 1      # G: the exact score met the cutoff; the walk ran
FLAG_DEMOTE = 2    # G: the approximate score missed the reduced cutoff
FLAG_RANGE = 8     # G: a read outside query or subject, or a bad index
GATE_ERROR = ("an approximate-gate walk reaches outside query or "
              "subject, or a seed's context or subject is out of range")
_CHUNK = 64        # plain gate: byte-steps scored per loop iteration


def check_gate_flags(flags) -> None:
    """ValueError if G marked a seed out of range (FLAG_RANGE). ``flags``
    is G's flags output or a numpy copy of it (a CUDA tensor is fetched,
    which waits on the card)."""
    f = flags.cpu().numpy() if isinstance(flags, torch.Tensor) else flags
    if (np.asarray(f) & FLAG_RANGE).any():
        raise ValueError(GATE_ERROR)


def query_bytes(query: torch.Tensor) -> torch.Tensor:
    """uint8[Q-3]: the truncated packing of the four query codes from
    each buffer position, ``((q0<<6)|(q1<<4)|(q2<<2)|q3) & 0xFF``;
    ambiguity codes (14, 15) bleed into the neighbouring slots, as in
    the reference's C. G reads one of these a byte-step; a batch builds
    them once (``engine/search.py::setup_batch``)."""
    q = query.long()
    if q.numel() < 4:
        return torch.zeros(0, dtype=torch.uint8, device=query.device)
    return (((q[:-3] << 6) | (q[1:-2] << 4) | (q[2:-1] << 2) | q[3:])
            & 0xFF).to(torch.uint8)


def right_run_ref(query_nib, subject_w, sub_ends, q_off, s_off, oid, *,
                  word_size: int):
    """Plain PyTorch version of RR (same arguments and result as
    ``right_run``): int32[n] runs, each the count of leading positions d
    < word_size at which the query nibble at q_off + word_size + d is
    ``1 << code`` of the subject code at s_off + word_size + d, both
    positions inside their arrays and the subject one before its owning
    subject's end."""
    from gblastn_tpu_torch.ops.seeding import _codes

    W = word_size
    n = q_off.numel()
    dev = q_off.device
    if n == 0 or W <= 0:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    q = q_off.long() + W
    s = s_off.long() + W
    o = oid.long()
    n_sub = sub_ends.numel()
    ok = (o >= 0) & (o < n_sub)
    hi = torch.where(ok, sub_ends.long()[o.clamp(0, max(n_sub - 1, 0))], 0)
    hi = hi.clamp(max=subject_w.numel() * 16)
    qmask = _codes(query_nib, q, 8, 4, W)
    scode = _codes(subject_w, s, 16, 2, W)
    d = torch.arange(W, dtype=torch.int64, device=dev)
    qi, si = q[:, None] + d, s[:, None] + d
    inb = ((qi >= 0) & (qi < query_nib.numel() * 8) & (si >= 0)
           & (si < hi[:, None]))
    match = inb & (qmask == (torch.ones_like(scode) << scode))
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)


def _reset_walk_ref(qbytes, packed, table, q0, qstep, s0, sstep, n_steps,
                    x):
    """(best, pos, steps) of one direction of the approximate walk for
    every seed, in int64: step j (1-based) scores table[qbytes[q0 +
    qstep*j] ^ packed[s0 + sstep*j]]; the running sum resets into best
    when it turns positive (pos = that step); the walk ends after the
    step that leaves it below -x, or after n_steps steps. ``steps``
    counts the steps taken. _CHUNK steps a loop iteration, over the live
    seeds only."""
    n = q0.numel()
    dev = q0.device
    best = torch.zeros(n, dtype=torch.int64, device=dev)
    pos = torch.zeros_like(best)
    steps = torch.zeros_like(best)
    run = torch.zeros_like(best)      # the prefix total so far
    act = torch.arange(n, device=dev)
    j = torch.arange(1, _CHUNK + 1, device=dev)
    col = j - 1
    nq, ns = max(qbytes.numel() - 1, 0), max(packed.numel() - 1, 0)
    qa, sa, na, xa = q0, s0, n_steps, x
    act = act[na > 0]
    qa, sa, na, xa = (t[na > 0] for t in (qa, sa, na, xa))
    base = 0
    while act.numel():
        jj = base + j
        qi = (qa[:, None] + qstep * jj).clamp_(0, nq)
        si = (sa[:, None] + sstep * jj).clamp_(0, ns)
        valid = jj[None, :] <= na[:, None]
        sc = table[qbytes[qi] ^ packed[si].long()].masked_fill_(~valid, 0)
        cs = torch.cumsum(sc, dim=1).add_(run[act, None])
        b0 = best[act]
        prev = torch.cat([b0[:, None], torch.maximum(
            b0[:, None], torch.cummax(cs, dim=1).values[:, :-1])], dim=1)
        up = cs > prev
        # the sum after the step: 0 where it turned positive
        after = torch.where(up, 0, cs - prev)
        dropped = (after < -xa[:, None]) & valid
        any_d = dropped.any(dim=1)
        first = torch.where(any_d, torch.argmax(dropped.to(torch.int32),
                                                dim=1), _CHUNK)
        # the dropping step is taken (a reset there counts)
        imp = up & valid & (col[None, :] <= first[:, None])
        has = imp.any(dim=1)
        last = _CHUNK - 1 - torch.argmax(imp.flip(1).to(torch.int32), dim=1)
        best[act] = torch.where(has, cs.gather(1, last[:, None])[:, 0], b0)
        pos[act] = torch.where(has, base + last + 1, pos[act])
        taken = torch.where(any_d, first + 1,
                            (na - base).clamp(0, _CHUNK))
        steps[act] += taken
        run[act] = cs[:, -1]
        keep = ~any_d & (na > base + _CHUNK)
        act, qa, sa, na, xa = (t[keep] for t in (act, qa, sa, na, xa))
        base += _CHUNK
    return best, pos, steps


def approx_gate_ref(qbytes, packed, table256, ctx_tables, sub_starts,
                    sub_ends, q_off, s_off, ctx, oid, ug_q, ug_s, ug_len,
                    ug_score, *, word_size: int, concat_end: int,
                    right_run=None, return_steps: bool = False):
    """Plain PyTorch version of G (same arguments and results as
    ``approx_gate``). With ``return_steps`` it also returns the byte-steps
    each seed's left and right walk took (int64[2, n]): the work count
    behind G's bound."""
    dev = q_off.device
    i64 = torch.int64
    n_ctx = ctx_tables.shape[1]
    n_sub = sub_starts.numel()
    c, o = ctx.long(), oid.long()
    ctx_ok = (c >= 0) & (c < n_ctx)
    cc = c.clamp(0, max(n_ctx - 1, 0))
    cut, red, xd = (ctx_tables[k].long()[cc] for k in range(3))
    sc0 = ug_score.long()
    need = ctx_ok & (sc0 >= cut)
    oc = o.clamp(0, max(n_sub - 1, 0))
    st, en = sub_starts.long()[oc], sub_ends.long()[oc]
    q, s = q_off.long(), s_off.long()
    s_loc = s - st
    adj = (4 - (s_loc & 3)) & 3
    q_ext = q - 1 + adj
    s_ext = s_loc + adj
    qb = q_ext + 1
    sb = (st >> 2) + (s_ext >> 2)
    n_left = torch.minimum(q_ext, s_ext) >> 2
    n_right = torch.minimum(concat_end - 1 - q_ext, (en - st) - s_ext) >> 2
    # the query length behind the packed bytes: a step at buffer position
    # p reads the codes p .. p + 3
    Q, P = qbytes.numel() + 3, packed.numel()
    left_ok = (n_left <= 0) | ((qb - 4 * n_left >= 0) & (qb <= Q)
                               & (sb - n_left >= 0) & (sb <= P))
    right_ok = (n_right <= 0) | ((qb >= 0) & (qb + 4 * n_right <= Q)
                                 & (sb >= 0) & (sb + n_right <= P))
    in_range = (o >= 0) & (o < n_sub) & left_ok & right_ok
    flags = torch.where(need, FLAG_NEED, 0)
    flags = torch.where(~ctx_ok | (need & ~in_range), flags | FLAG_RANGE,
                        flags)
    walk = torch.nonzero(need & in_range).squeeze(1)
    qbytes = qbytes.long()
    table = table256.long()
    pk = packed.long() if packed.numel() else packed.new_zeros(1).long()
    w = (qb[walk], sb[walk], xd[walk])
    l_best, l_pos, l_steps = _reset_walk_ref(
        qbytes, pk, table, w[0], -4, w[1], -1, n_left[walk], w[2])
    r_best, r_pos, r_steps = _reset_walk_ref(
        qbytes, pk, table, w[0] - 4, 4, w[1] - 1, 1, n_right[walk], w[2])
    a_score = l_best + r_best
    dem = a_score < red[walk]
    qe, se = q_ext[walk], s_ext[walk]
    a_q = qe - 4 * l_pos + 1
    a_s = se - 4 * l_pos + st[walk]
    a_r = torch.where(r_pos > 0, qe + 4 * r_pos - 1, qe) + 1
    word_end = s[walk] + word_size
    if right_run is not None:
        word_end = word_end + right_run.long()[walk]
    a_len = torch.maximum(word_end - a_s, a_r - a_q + 1)
    outs = [t.to(i64).clone() for t in (ug_q, ug_s, ug_len, ug_score)]
    d = walk[dem]
    for out, a in zip(outs, (a_q, a_s, a_len, a_score)):
        out[d] = a[dem]
    flags[d] |= FLAG_DEMOTE
    i32 = torch.int32
    outs = (outs[0].to(i32), outs[1], outs[2].to(i32), outs[3].to(i32),
            flags.to(i32))
    if return_steps:
        steps = torch.zeros(2, q_off.numel(), dtype=i64, device=dev)
        steps[0, walk] = l_steps
        steps[1, walk] = r_steps
        return outs + (steps,)
    return outs


_KEY_FIELDS = ((1, "oid"), (2, "s"), (4, "q"))    # key_range_flag's bits


def key_range_flag(q_off, s_loc, oid, *, n_sub: int, s_len: int,
                   q_len: int) -> torch.Tensor:
    """int32 scalar on the seeds' device: bit 1 where an oid lies outside
    [0, n_sub), 2 where a subject-local s lies outside [0, s_len), 4
    where a q_off lies outside [0, q_len) (``replay_keys``' bounds); 0
    where every field fits. Waits on nothing: the caller fetches it with
    its results and raises there (``check_key_flag``)."""
    flag = torch.zeros((), dtype=torch.int32, device=q_off.device)
    for (bit, _name), v, bound in zip(_KEY_FIELDS, (oid, s_loc, q_off),
                                      (n_sub, s_len, q_len)):
        v = v.long()
        flag |= ((v < 0) | (v >= bound)).any().to(torch.int32) * bit
    return flag


def check_key_flag(flag) -> None:
    """ValueError naming the fields that ``key_range_flag`` found past
    their bounds (``flag``: its value, a tensor or a numpy copy; a CUDA
    tensor is fetched, which waits on the card)."""
    f = int(flag.cpu().numpy().ravel()[0] if isinstance(flag, torch.Tensor)
            else np.asarray(flag).ravel()[0])
    if f:
        names = ", ".join(name for bit, name in _KEY_FIELDS if f & bit)
        raise ValueError(f"replay_keys: {names} outside the bounds the "
                         "key was packed for")


def _bits(v) -> int:
    return max(int(v), 0).bit_length()


def key_layout(n_sub: int, s_len: int, q_len: int, diag_mask: int):
    """(diagonal bits, s bits, q bits) of the one-sort replay key, or None
    where it needs more than 63 bits. Most significant first, the key
    holds the oid (< ``n_sub``), the masked diagonal (``(s - q) & mask``
    with a mask, else ``s - q + q_len - 1``, so it is not negative), the
    subject-local s (< ``s_len``) and, only with a mask, q (< ``q_len``):
    without one, q = s - diagonal follows from the fields before it."""
    b_o, b_s = _bits(n_sub - 1), _bits(s_len - 1)
    if diag_mask:
        b_d, b_q = _bits(diag_mask), _bits(q_len - 1)
    else:
        b_d, b_q = _bits(s_len + q_len - 2), 0
    return None if b_o + b_d + b_s + b_q > 63 else (b_d, b_s, b_q)


def replay_keys(q_off, s_loc, oid, diag_mask: int, *, n_sub: int,
                s_len: int, q_len: int, two_sorts: bool = False):
    """(key, order, key_shift): the seeds in replay order, stable, as the
    host's ``np.lexsort((q, s, diag, oid))`` orders them: by (oid, masked
    diagonal, s, q), ties by index. ``order`` holds the seeds' indices
    (int64), ``key`` the sorted keys, and ``key >> key_shift`` is equal
    exactly within a segment (one oid and masked diagonal).

    Every oid lies in [0, n_sub), every subject-local s in [0, s_len)
    and every q_off in [0, q_len) (the batch's subject count, longest
    subject and query buffer; checked here on CPU tensors, where a value
    out of its bound raises ValueError: its field would overwrite the
    next; on the card the caller flags it with ``key_range_flag``).
    Where ``key_layout`` fits 63 bits, one stable sort of the packed key
    (``key_shift`` = the bits of s and q); else (or with ``two_sorts``)
    two stable sorts, the secondary key (s, q) first, then the primary
    (oid, masked diagonal made non-negative as in the packed key;
    ``key_shift`` 0), each field as wide as its bound needs (a subject
    past 2^32 bases included). Bounds whose two-sort keys would pass 63
    bits raise ValueError."""
    q = q_off.long()
    s = s_loc.long()
    if q.device.type == "cpu" and q.numel():
        for name, v, bound in (("oid", oid, n_sub), ("s", s, s_len),
                               ("q", q, q_len)):
            if int(v.min()) < 0 or int(v.max()) >= bound:
                raise ValueError(f"replay_keys: {name} outside [0, {bound})")
    layout = (None if two_sorts
              else key_layout(n_sub, s_len, q_len, diag_mask))
    d = (s - q) & diag_mask if diag_mask else s - q + (q_len - 1)
    if layout is not None:
        b_d, b_s, b_q = layout
        key = (((oid.long() << b_d) | d) << b_s) | s
        if b_q:
            key = (key << b_q) | q
        key, order = torch.sort(key, stable=True)
        return key, order, b_s + b_q
    b_o, b_s, b_q = _bits(n_sub - 1), _bits(s_len - 1), _bits(q_len - 1)
    b_d = _bits(diag_mask) if diag_mask else _bits(s_len + q_len - 2)
    if b_o + b_d > 63 or b_s + b_q > 63:
        raise ValueError(f"replay_keys: bounds n_sub {n_sub}, s_len "
                         f"{s_len}, q_len {q_len} need keys past 63 bits")
    o1 = torch.sort((s << b_q) | q, stable=True).indices
    key, o2 = torch.sort(((oid.long() << b_d) | d)[o1], stable=True)
    return key, o1[o2], 0


def diag_replay_ref(key, order, s_loc, end_loc, score, cutoff, *,
                    word_size: int, window: int = 0, right_run=None,
                    key_shift: int = 0):
    """Plain PyTorch version of R (same arguments and result as
    ``diag_replay``), by state jumping: every segment (a run of equal
    ``key >> key_shift``) holds its current seed, which the machine
    processes (it is never skipped); the next one is the first later
    seed of the segment with s >= last_hit, found for all segments at
    once by one ``searchsorted`` over (segment, s), which ascends."""
    n = key.numel()
    dev = key.device
    saved_sorted = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        W = word_size
        s = s_loc.long()[order]
        passed = score[order] >= cutoff[order]
        end = end_loc.long()[order]
        run = (right_run.long()[order] if right_run is not None and window
               else torch.zeros_like(s))
        head = torch.ones(n, dtype=torch.bool, device=dev)
        seg_key = key >> key_shift
        head[1:] = seg_key[1:] != seg_key[:-1]
        seg = torch.cumsum(head, 0) - 1
        comb = (seg << 32) + s
        cur = torch.nonzero(head).squeeze(1)
        ends = torch.cat([cur[1:], cur.new_full((1,), n)])
        last = torch.full_like(cur, -window)     # per live segment
        flag = torch.zeros_like(cur, dtype=torch.bool)
        while cur.numel():
            sc = s[cur]
            word_end = sc + W
            if window:
                first = flag | (word_end > last + window)
                word_end = torch.where(first, word_end + run[cur], word_end)
                ready = ~first | (run[cur] >= W)
                p = ready & passed[cur]
            else:
                p = passed[cur]
            saved_sorted[cur[p]] = True
            last = torch.where(p, end[cur], word_end)
            nxt = torch.searchsorted(comb, (seg[cur] << 32) + last)
            nxt = torch.maximum(nxt, cur + 1)
            alive = nxt < ends
            cur, ends = nxt[alive], ends[alive]
            last, flag = last[alive], p[alive]
    saved = torch.zeros(n, dtype=torch.uint8, device=dev)
    saved[order] = saved_sorted.to(torch.uint8)
    return saved


def _check_args(name, dev, specs):
    for arg, t, dt in specs:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous {dt} on "
                             f"{dev}, got {t.dtype} on {t.device}")


_lib_fns = None


def _bind():
    """The kernels' entry points and PyTorch's raw-stream and capture
    queries, bound once."""
    global _lib_fns
    if _lib_fns is None:
        from gblastn_tpu_torch.ops import _build

        lib = _build.load()
        _lib_fns = (lib.gblastn_approx_gate, lib.gblastn_diag_replay,
                    lib.gblastn_right_run,
                    torch._C._cuda_getCurrentRawStream,
                    torch._C._cuda_isCurrentStreamCapturing)
    return _lib_fns


def _launch(fn, index, args, what):
    if index == torch._C._cuda_getDevice():
        rc = fn(*args)
    else:
        with torch.cuda.device(index):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def approx_gate(qbytes, packed, table256, ctx_tables, sub_starts, sub_ends,
                q_off, s_off, ctx, oid, ug_q, ug_s, ug_len, ug_score, *,
                word_size: int, concat_end: int, right_run=None):
    """G: the approximate-ungapped gate on every seed of K1's output.

    qbytes uint8[Q-3] (``query_bytes`` of the BLASTNA query buffer),
    packed uint8[S/4] (the
    resident 2-bit subject, pad-aligned), table256 int32[256]
    (``nucl_score_table_packed``), ctx_tables int32[3, n_ctx] (word
    cutoff, reduced cutoff, x_drop per context), sub_starts and sub_ends
    int64[num_seqs], and [n] seeds: q_off (buffer), s_off (global), ctx,
    oid, and K1's q_start, s_start, length, score, each int32 but s_off
    and s_start, which are int64 (on the CPU any integer type).
    ``concat_end`` is one past the query buffer's last real base;
    ``right_run`` (int32[n], RR's, or None for runs of 0) extends a
    demoted seed's word end. Returns [n] (q_start, s_start, length,
    score, flags), s_start int64 and the rest int32: the rows with the
    demoted seeds' approximate extension substituted, and FLAG_NEED /
    FLAG_DEMOTE / FLAG_RANGE. CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream without waiting on
    the card. Launches count in ``approx_gate.launches`` (in
    ``.captured`` while a graph captures)."""
    seeds = (q_off, s_off, ctx, oid, ug_q, ug_s, ug_len, ug_score)
    tables = (qbytes, packed, table256, ctx_tables, sub_starts, sub_ends)
    runs = () if right_run is None else (right_run,)
    if all(t.device.type == "cpu" for t in tables + seeds + runs):
        return approx_gate_ref(*tables, *seeds, word_size=word_size,
                               concat_end=concat_end, right_run=right_run)
    dev = q_off.device
    if dev.type != "cuda":
        raise ValueError(f"approx_gate: no kernel for {dev}")
    n = q_off.numel()
    _check_args("approx_gate", dev, [
        ("qbytes", qbytes, torch.uint8), ("packed", packed, torch.uint8),
        ("table256", table256, torch.int32),
        ("ctx_tables", ctx_tables, torch.int32),
        ("sub_starts", sub_starts, torch.int64),
        ("sub_ends", sub_ends, torch.int64),
    ] + [(f"seed array {k}", t, torch.int64 if k in (1, 5) else torch.int32)
         for k, t in enumerate(seeds + runs)])
    if (table256.numel() != 256 or ctx_tables.dim() != 2
            or ctx_tables.shape[0] != 3 or sub_ends.numel()
            != sub_starts.numel()
            or any(t.numel() != n for t in seeds + runs)):
        raise ValueError("approx_gate: table or seed array of the wrong "
                         "shape")
    if max(qbytes.numel() + 3, n) >= 2**31:
        raise ValueError("approx_gate: query or seed count too large for "
                         "32-bit offsets")
    q, length, score, flags = torch.empty((4, n), dtype=torch.int32,
                                          device=dev).unbind(0)
    outs = (q, torch.empty(n, dtype=torch.int64, device=dev), length, score,
            flags)
    if n == 0:
        return outs
    fn, _r, _rr, raw_stream, capturing = _lib_fns or _bind()
    args = (*(t.data_ptr() for t in tables), *(t.data_ptr() for t in seeds),
            right_run.data_ptr() if runs else None,
            qbytes.numel(), packed.numel(), ctx_tables.shape[1],
            sub_starts.numel(), n, word_size, concat_end,
            *(o.data_ptr() for o in outs), raw_stream(dev.index))
    _launch(fn, dev.index, args, "approx_gate")
    if capturing():
        approx_gate.captured += 1
    else:
        approx_gate.launches += 1
    return outs


approx_gate.launches = 0
approx_gate.captured = 0


def diag_replay(key, order, s_loc, end_loc, score, cutoff, *,
                word_size: int, window: int = 0, right_run=None,
                key_shift: int = 0):
    """R: the one-hit (``window`` 0) or two-hit replay over seeds in
    replay order.

    key, order and key_shift from ``replay_keys`` (a segment is a run of
    equal ``key >> key_shift``); [n] per seed (in the original order):
    s_loc (subject-local seed start) and end_loc (the subject-local end of
    its ungapped extension, after G), both int32 or both int64 (the wide
    kernels: a subject past 2^31 bases), and int32 score (after G) and
    cutoff; for two-hit, ``right_run`` (int32, RR's, or None for runs of
    0; one-hit ignores it). Returns uint8[n] saved, in the original
    order. CPU tensors run the plain version; CUDA tensors launch the
    kernel (a segment a thread, at its head; long skips searched for) on
    the current stream without waiting on the card. Launches count in
    ``diag_replay.launches`` (in ``.captured`` while a graph captures)."""
    tensors = (key, order, s_loc, end_loc, score, cutoff)
    runs = () if right_run is None or not window else (right_run,)
    if all(t.device.type == "cpu" for t in tensors + runs):
        return diag_replay_ref(*tensors, word_size=word_size, window=window,
                               right_run=right_run, key_shift=key_shift)
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"diag_replay: no kernel for {dev}")
    n = key.numel()
    wide = s_loc.dtype == torch.int64
    coord = torch.int64 if wide else torch.int32
    _check_args("diag_replay", dev, [
        ("key", key, torch.int64), ("order", order, torch.int64),
        ("s_loc", s_loc, coord), ("end_loc", end_loc, coord),
        ("score", score, torch.int32), ("cutoff", cutoff, torch.int32)]
        + [("right_run", t, torch.int32) for t in runs])
    if any(t.numel() != n for t in tensors + runs) or n >= 2**31:
        raise ValueError("diag_replay: arrays of different lengths, or "
                         "too many seeds for one launch")
    if not 0 <= window < 2**30 or not 0 <= key_shift < 64:
        raise ValueError(f"diag_replay: window {window} or key_shift "
                         f"{key_shift} out of range")
    saved = torch.zeros(n, dtype=torch.uint8, device=dev)   # R writes 1s
    if n == 0:
        return saved
    _g, fn, _rr, raw_stream, capturing = _lib_fns or _bind()
    args = (*(t.data_ptr() for t in tensors),
            right_run.data_ptr() if runs else None, n, word_size, window,
            key_shift, int(wide), saved.data_ptr(), raw_stream(dev.index))
    _launch(fn, dev.index, args, "diag_replay")
    if capturing():
        diag_replay.captured += 1
    else:
        diag_replay.launches += 1
    return saved


diag_replay.launches = 0
diag_replay.captured = 0


_RR_SPECS = (("query_nib", torch.int64), ("subject_w", torch.int64),
             ("sub_ends", torch.int64), ("q_off", torch.int32),
             ("s_off", torch.int64), ("oid", torch.int32))


def right_run(query_nib, subject_w, sub_ends, q_off, s_off, oid, *,
              word_size: int):
    """RR: the double-word probe on every seed.

    query_nib int64[Q/8] (``ops.seeding.pack_query_nibbles``: eight
    4na-mask nibbles a word), subject_w int64[S/16] (the resident
    ``subject_w``: sixteen 2-bit codes a word), sub_ends int64[num_seqs]
    (each subject's end), and [n] seeds: int32 q_off (buffer), int64 s_off
    (global; on the CPU any integer type) and int32 oid (the owning
    subject). Returns int32[n] runs, each
    at most ``word_size``. CPU tensors run the plain version; CUDA
    tensors launch the kernel (a thread a seed, sixteen bases a step) on
    the current stream without waiting on the card. Launches count in
    ``right_run.launches`` (in ``.captured`` while a graph captures).

    The checks of a CUDA call (one device, dtypes, contiguity, lengths,
    32-bit query offsets) read each tensor's attributes once: a call's
    host work is several times the launch."""
    tensors = (query_nib, subject_w, sub_ends, q_off, s_off, oid)
    if not q_off.is_cuda:
        if all(t.device.type == "cpu" for t in tensors):
            return right_run_ref(*tensors, word_size=word_size)
        raise ValueError(f"right_run: no kernel for {q_off.device}")
    dev = q_off.get_device()
    for t, (arg, dt) in zip(tensors, _RR_SPECS):
        if t.get_device() != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"right_run: {arg} must be contiguous {dt} on "
                             f"{q_off.device}, got {t.dtype} on {t.device}")
    n = q_off.numel()
    if s_off.numel() != n or oid.numel() != n:
        raise ValueError("right_run: seed arrays of different lengths")
    q8, s16 = query_nib.numel(), subject_w.numel()
    if not 0 <= word_size <= 64 or max(8 * q8, n) >= 2**31:
        raise ValueError("right_run: word size outside [0, 64], or a "
                         "query or seed count too large for 32-bit "
                         "offsets")
    run = torch.empty(n, dtype=torch.int32, device=q_off.device)
    if n == 0:
        return run
    _g, _r, fn, raw_stream, capturing = _lib_fns or _bind()
    _launch(fn, dev, (
        query_nib.data_ptr(), subject_w.data_ptr(), sub_ends.data_ptr(),
        q_off.data_ptr(), s_off.data_ptr(), oid.data_ptr(), q8, s16,
        sub_ends.numel(), n, word_size, run.data_ptr(), raw_stream(dev)),
        "right_run")
    if capturing():
        right_run.captured += 1
    else:
        right_run.launches += 1
    return run


right_run.launches = 0
right_run.captured = 0
