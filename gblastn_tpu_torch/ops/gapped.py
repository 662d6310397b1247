"""K2, the banded gapped-DP rejection filter: wrapper, plain version,
job layout.

The port's counterpart of ``gblastn_tpu/ops/pallas_gapped.py``. The
kernel itself is ``csrc/gapped_band.cu`` (one warp per job);
``banded_gapped_scores_ref`` is its plain PyTorch version, vectorised
over jobs as ``[jobs, 128]`` tensors with a Python loop over rows, and
``banded_gapped_scores`` dispatches on where the tensors live: CPU
tensors go to the plain version, CUDA tensors to the kernel (or an
exception). There is no fallback between the two.

Semantics are those of ``gblastn_tpu/ops/gapped_ref.py::banded_dp_score``
for every job (one direction of one seed):

* an affine-gap DP restricted to W = 128 diagonals centred on the seed's
  diagonal (band position p of row i holds column j = i + p - 64);
* the horizontal-gap recurrence as an inclusive prefix max over the band;
* F kept sticky on pruned cells;
* an X-drop threshold refreshed every STEP = 8 rows from the best so far
  (X = max(x, gap_open + gap_extend)), and a death latch at those group
  boundaries, after which the job stops;
* ``FLAG_EDGE`` when a live cell, row 0 included, touched band position 0
  or 127, ``FLAG_ROWS`` when still alive after ``rows`` rows with M > rows;
* a job with M <= 0 or N <= 0 returns (0, 0); otherwise the score is
  max(best, 0).

A right job reads ``subject2[a0 + i - 1]`` down its rows and
``query[b0 + j - 1]`` along its columns; a left job reads
``subject2[a0 - i]`` and ``query[b0 - j]``. ``gapped_jobs`` lays out the
right jobs of all seeds, then their left jobs, and ``fold_directions``
sums the two scores of a seed and ORs its flags (the JAX package does both
inside its ``banded_gapped_scores``, pallas_gapped.py:453-505). Scores are
int32 with NEG = -2^24, as in the oracle; the score matrix is used
unclipped.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

NEG = -(1 << 24)
NEGH = NEG // 2
W = 128                 # band width (diagonals)
HALF = W // 2
STEP = 8                # rows per X-drop / death group
MAX_X = 1 << 22         # x_drop and gap_open + gap_extend stay below this
                        # (the kernel's ungated forms need thr > NEG/2)

FLAG_EDGE = 1
FLAG_ROWS = 2


@dataclass
class GappedJobs:
    """One launch's jobs: right extensions of every seed, then left ones.

    ``check_jobs`` fills ``order`` (the launch order, longest row budget
    first) and ``checked`` (the query length, subject length and row
    budget the job ranges were checked against); the kernel takes only
    such a job set, so a launch never reads a check back from the card."""

    a0: torch.Tensor        # int64[J] subject seed point
    b0: torch.Tensor        # int64[J] query seed point
    m: torch.Tensor         # int32[J] subject steps (rows)
    n: torch.Tensor         # int32[J] query steps (columns)
    x: torch.Tensor         # int32[J] X-drop (kernel score scale)
    n_right: int            # jobs [0, n_right) are right, the rest left
    order: torch.Tensor | None = None            # int32[J] (check_jobs)
    checked: tuple[int, int, int] | None = None  # (q_len, s_len, rows)

    def __len__(self) -> int:
        return int(self.m.shape[0])

    def to(self, device) -> "GappedJobs":
        """The same jobs on ``device``, in one host-to-device copy."""
        device = torch.device(device)
        if self.a0.device == device:
            return self
        cols = [self.a0, self.b0, self.m.long(), self.n.long(),
                self.x.long()]
        if self.order is not None:
            cols.append(self.order.long())
        packed = torch.stack(cols).to(device)
        i32 = torch.int32
        return dataclasses.replace(
            self, a0=packed[0], b0=packed[1], m=packed[2].to(i32),
            n=packed[3].to(i32), x=packed[4].to(i32),
            order=packed[5].to(i32) if self.order is not None else None)


def scan_reach(x: int, gap_open: int, gap_extend: int,
               reward_max: int) -> int:
    """Band positions back that the horizontal-gap scan must reach for a
    job of X-drop ``x`` (the port of pallas_gapped.py::_scan_steps, in
    positions instead of TPU scan steps): with e = gap_extend > 0, an E
    source g = (X + 9 r - oe) // e + 1 or more positions back (X =
    max(x, oe), r = max(reward_max, 0)) can never make a live cell, so a
    scan over distances 1 .. g gives the full scan's results (the proof is
    in csrc/gapped_band.cu). e <= 0: the whole band. At most W."""
    oe = gap_open + gap_extend
    if gap_extend <= 0:
        return W
    X = max(x, oe)
    g = (X + 9 * max(reward_max, 0) - oe) // gap_extend + 1
    return min(g, W)


def row_budget(m: torch.Tensor, n: torch.Tensor, rows: int) -> torch.Tensor:
    """The most rows a job can compute: min(M, rows, N + HALF), 0 for an
    empty job. Past row N + HALF every band position lies beyond column N,
    so the job dies at the next group boundary."""
    return torch.where((m > 0) & (n > 0),
                       torch.minimum(m.clamp(max=rows), n + HALF), 0)


def job_order(m: torch.Tensor, n: torch.Tensor, rows: int) -> torch.Tensor:
    """int32 launch order of jobs: by ``row_budget``, largest first, ties
    in the caller's order. The kernel runs slot k's job ``order[k]`` and
    writes its result at that index."""
    budget = row_budget(m, n, rows)
    return torch.argsort(budget, descending=True, stable=True).to(
        torch.int32)


def check_jobs(jobs: GappedJobs, q_len: int, s_len: int,
               rows: int) -> GappedJobs:
    """The job set with its ranges checked and its launch order set.

    Raises ValueError when a job with work (M > 0, N > 0) would read
    outside a query of ``q_len`` bytes or a subject of ``s_len`` codes
    within ``rows`` rows, or has x_drop >= MAX_X. It reads one pair of
    flags back from the jobs' device: build the set on the host and move
    it with ``GappedJobs.to`` (engine.gapped does) to keep the card's
    stream free of it."""
    J = len(jobs)
    if J:
        dev = jobs.m.device
        right = torch.arange(J, device=dev) < jobs.n_right
        work = (jobs.m > 0) & (jobs.n > 0)
        r = torch.minimum(jobs.m.long(), torch.full_like(jobs.a0, rows))
        n = jobs.n.long()
        a_lo = torch.where(right, jobs.a0, jobs.a0 - r)
        a_hi = torch.where(right, jobs.a0 + r, jobs.a0)
        b_lo = torch.where(right, jobs.b0, jobs.b0 - n)
        b_hi = torch.where(right, jobs.b0 + n, jobs.b0)
        bad = work & ((a_lo < 0) | (a_hi > s_len) | (b_lo < 0)
                      | (b_hi > q_len))
        outside, big_x = torch.stack([bad.any(),
                                      (jobs.x >= MAX_X).any()]).tolist()
        if outside:
            raise ValueError("a gapped job reaches outside query or subject")
        if big_x:
            raise ValueError(f"jobs.x: x_drop must be below {MAX_X}")
    return dataclasses.replace(jobs, order=job_order(jobs.m, jobs.n, rows),
                               checked=(q_len, s_len, rows))


def gapped_jobs(q_seed, s_seed, q_lo, q_hi, s_lo, s_hi, x_drop) -> GappedJobs:
    """Right and left jobs of seeds given as int64 tensors (global
    coordinates; [q_lo, q_hi) the seed's query context, [s_lo, s_hi) its
    subject) and an int32 X-drop each. The seed point itself belongs to
    the right job's row/column 1; the left job starts one base below."""
    i32 = torch.int32
    return GappedJobs(
        a0=torch.cat([s_seed, s_seed]),
        b0=torch.cat([q_seed, q_seed]),
        m=torch.cat([s_hi - s_seed, s_seed - s_lo]).to(i32),
        n=torch.cat([q_hi - q_seed, q_seed - q_lo]).to(i32),
        x=torch.cat([x_drop, x_drop]).to(i32),
        n_right=int(q_seed.shape[0]),
    )


def fold_directions(score, flags, n_seeds: int):
    """(int64 total, int32 flags) per seed: the right job's score plus the
    left job's, and their flags ORed."""
    total = score[:n_seeds].long() + score[n_seeds:].long()
    return total, flags[:n_seeds] | flags[n_seeds:]


def _window_max(u, g):
    """excl[a, p] = max(u[a, p - g[a] .. p - 1]) (NEG where the window
    holds nothing), for windows 1 <= g <= W: the larger of two windows of
    the largest power of two 2^K <= g, ending at p - 1 and at
    p - 1 - (g - 2^K)."""
    A = u.shape[0]
    levels = [u]
    for k in range(1, 8):
        cur = levels[-1]
        sh = 1 << (k - 1)
        levels.append(torch.maximum(cur, torch.cat(
            [torch.full_like(cur[:, :sh], NEG), cur[:, :-sh]], 1)))
    K = torch.floor(torch.log2(g.double())).long()
    span = torch.stack(levels)[K, torch.arange(A, device=u.device)]
    padded = torch.cat([torch.full((A, W + 1), NEG, dtype=span.dtype,
                                   device=span.device), span], 1)
    p = torch.arange(W, device=u.device)
    near = padded[:, p + W].contiguous()
    far = torch.gather(padded, 1, p + W - (g - 2 ** K)[:, None])
    return torch.maximum(near, far)


def banded_gapped_scores_ref(query, subject2, matrix16, jobs: GappedJobs,
                             *, rows: int, gap_open: int, gap_extend: int,
                             return_cells: bool = False,
                             cut_scan: bool = False):
    """Plain PyTorch version of K2 (same arguments and results as
    ``banded_gapped_scores``). With ``return_cells`` it also returns the
    cells each job computed (int64[J]): the band cells with column j in
    [0, N] of every row before the job died or ran out, the work count
    behind K2's bound.

    ``cut_scan`` (for tests; no path uses it) computes E as the kernel
    does: the horizontal-gap max taken only over the ``scan_reach``
    positions before each cell, and u and E not gated at NEG/2. Its
    results must equal the full scan's."""
    dev = query.device
    J = len(jobs)
    oe = gap_open + gap_extend
    e = gap_extend
    mat = matrix16.reshape(16, 4).long()
    m = jobs.m.long()
    n = jobs.n.long()
    X = jobs.x.long().clamp(min=oe)
    right = torch.arange(J, device=dev) < jobs.n_right
    sgn = torch.where(right, 1, -1)
    lanes = torch.arange(W, dtype=torch.int64, device=dev)
    Q, S = query.shape[0], subject2.shape[0]
    if cut_scan:
        r_max = max(int(mat.max()), 0)
        reach = ((X + 9 * r_max - oe) // e + 1).clamp(max=W) if e > 0 \
            else torch.full_like(X, W)

    # row 0: H(0, j) = -open - j*e for j in [0, N]; lane p -> j = p - HALF
    jj0 = lanes - HALF
    h = torch.where(jj0 == 0, 0, -gap_open - jj0 * e).expand(J, W)
    h = torch.where((jj0 >= 0) & (jj0 <= n[:, None]), h, NEG)
    h = torch.where((jj0 > 0) & (-gap_open - jj0 * e < -X[:, None]), NEG, h)
    H = h.clone()
    F = torch.where(H > NEGH, H - oe, NEG)
    bestlane = H.clone()
    dead = torch.zeros(J, dtype=torch.bool, device=dev)
    cells = torch.zeros(J, dtype=torch.int64, device=dev)

    R = torch.minimum(m, torch.full_like(m, rows))
    empty = (m <= 0) | (n <= 0)
    act = torch.nonzero(~empty & (R > 0)).squeeze(1)
    i = 0
    while act.numel():
        Ha, Fa, Ba = H[act], F[act], bestlane[act]
        Ra, na, Xa = R[act], n[act], X[act]
        ga = reach[act] if cut_scan else None
        a0, b0, sg = jobs.a0[act], jobs.b0[act], sgn[act]
        ca = cells[act]
        thr = Ba.max(dim=1).values.clamp(min=0) - Xa
        for _ in range(STEP):
            i += 1
            on = (i <= Ra)[:, None]          # rows past R change nothing
            sidx = torch.where(sg > 0, a0 + i - 1, a0 - i).clamp(0, S - 1)
            a_code = subject2[sidx].long()
            jj = i + lanes - HALF                                 # [W]
            incol = (jj >= 1) & (jj <= na[:, None])               # [A, W]
            qidx = torch.where(sg[:, None] > 0, b0[:, None] + jj - 1,
                               b0[:, None] - jj).clamp(0, Q - 1)
            msc = mat[query[qidx].long(), a_code[:, None]]
            diag = torch.where(incol, Ha + msc, NEG)
            # the vertical predecessor (i-1, j) sat one band position up
            Fv = torch.cat([Fa[:, 1:], torch.full_like(Fa[:, :1], NEG)], 1)
            Ht = torch.maximum(diag, Fv)
            if cut_scan:
                excl = _window_max(Ht + lanes * e, ga)
                E = excl - oe - lanes * e
            else:
                u = torch.where(Ht > NEGH, Ht + lanes * e, NEG)
                run = torch.cummax(u, dim=1).values
                excl = torch.cat([torch.full_like(run[:, :1], NEG),
                                  run[:, :-1]], 1)
                E = torch.where(excl > NEGH, excl - oe - lanes * e, NEG)
            Hn = torch.maximum(Ht, E)
            inrange = (jj >= 0) & (jj <= na[:, None])
            Hn = torch.where(inrange, Hn, NEG)
            if return_cells:
                ca = ca + (inrange & on).sum(dim=1)
            Hn = torch.where(Hn < thr[:, None], NEG, Hn)
            live = Hn > NEGH
            Fn = torch.where(live, torch.maximum(Fv - e, Hn - oe), Fv)
            Ha = torch.where(on, Hn, Ha)
            Fa = torch.where(on, Fn, Fa)
            Ba = torch.where(on, torch.maximum(Ba, Hn), Ba)
        # group boundary: death latch, then drop finished jobs
        died = ~(Ha > NEGH).any(dim=1)
        H[act], F[act], bestlane[act] = Ha, Fa, Ba
        dead[act] = died
        cells[act] = ca
        act = act[~died & (Ra > i)]

    score = bestlane.max(dim=1).values.clamp(min=0)
    edge = (bestlane[:, 0] > NEGH) | (bestlane[:, W - 1] > NEGH)
    flags = (torch.where(edge, FLAG_EDGE, 0)
             + torch.where(~dead & (m > rows), FLAG_ROWS, 0))
    score = torch.where(empty, 0, score).to(torch.int32)
    flags = torch.where(empty, 0, flags).to(torch.int32)
    if return_cells:
        return score, flags, cells
    return score, flags


def _covered(jobs: GappedJobs, q_len: int, s_len: int, rows: int) -> bool:
    """Whether ``check_jobs`` checked these jobs for reads within q_len
    and s_len over at least ``rows`` rows."""
    c = jobs.checked
    return (c is not None and jobs.order is not None and c[0] <= q_len
            and c[1] <= s_len and c[2] >= rows)


def _check_kernel_args(query, subject2, matrix16, jobs: GappedJobs,
                       rows: int):
    """Host-only checks of a launch's arguments: dtypes, shapes, devices,
    contiguity, and that the job set was range-checked for this query,
    subject and row budget. Unchecked CPU jobs are checked here; unchecked
    CUDA jobs are refused, since checking them would wait on the card."""
    dev = query.device
    for name, t, dt in (("query", query, torch.uint8),
                        ("subject2", subject2, torch.int8),
                        ("matrix16", matrix16, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dt} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if matrix16.shape not in ((64,), (16, 4)):
        raise ValueError("matrix16 must hold 16 x 4 scores")
    J = len(jobs)
    if J >= 2**31 or not 0 <= jobs.n_right <= J:
        raise ValueError("bad job count")
    fields = [("a0", jobs.a0, torch.int64), ("b0", jobs.b0, torch.int64),
              ("m", jobs.m, torch.int32), ("n", jobs.n, torch.int32),
              ("x", jobs.x, torch.int32)]
    if jobs.order is not None:
        fields.append(("order", jobs.order, torch.int32))
    for name, t, dt in fields:
        if (t.device != dev or t.dtype != dt or t.dim() != 1
                or t.numel() != J or not t.is_contiguous()):
            raise ValueError(f"jobs.{name}: want contiguous 1-D {dt} of "
                             f"length {J} on {dev}")
    if _covered(jobs, query.numel(), subject2.numel(), rows):
        return
    if dev.type != "cpu":
        raise ValueError(
            "jobs: not range-checked for this query, subject and rows; "
            "build them with check_jobs (a launch reads nothing back from "
            "the card)")
    check_jobs(jobs, query.numel(), subject2.numel(), rows)


_lib_fns = None


def _bind():
    """The kernel's entry point and PyTorch's raw-stream and capture
    queries, bound once."""
    global _lib_fns
    if _lib_fns is None:
        from gblastn_tpu_torch.ops import _build

        _lib_fns = (_build.load().gblastn_gapped_band,
                    torch._C._cuda_getCurrentRawStream,
                    torch._C._cuda_isCurrentStreamCapturing)
    return _lib_fns


def banded_gapped_scores(query, subject2, matrix16, jobs: GappedJobs, *,
                         rows: int, gap_open: int, gap_extend: int):
    """K2: score-only banded gapped DP of every job.

    query uint8[Q] BLASTNA codes, subject2 int8[S] 2-bit codes, matrix16
    int32[16, 4] (query code x subject code, kernel score scale), and the
    jobs of ``gapped_jobs``. Returns int32 (score, flags) per job. CPU
    tensors run the plain version. CUDA tensors need a job set from
    ``check_jobs`` and launch the kernel on the current stream without
    waiting on the card, so the launch can be captured in a CUDA graph;
    the launch is counted in ``banded_gapped_scores.launches``, or, while
    the stream captures a graph, in ``banded_gapped_scores.captured``
    (whoever replays the graph adds it to ``launches`` at each replay, as
    ``tools.timing.graph_ms`` does)."""
    tensors = (query, subject2, matrix16, jobs.a0, jobs.b0, jobs.m, jobs.n,
               jobs.x)
    if all(t.device.type == "cpu" for t in tensors):
        return banded_gapped_scores_ref(query, subject2, matrix16, jobs,
                                        rows=rows, gap_open=gap_open,
                                        gap_extend=gap_extend)
    # the tensors checked are the tensors launched
    _check_kernel_args(query, subject2, matrix16, jobs, rows)
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"banded_gapped_scores: no kernel for {dev}")
    if not (0 <= gap_open and 0 <= gap_extend
            and gap_open + gap_extend < MAX_X and 0 < rows < 2**30):
        raise ValueError(f"gap_open {gap_open}, gap_extend {gap_extend}, "
                         f"rows {rows}: out of the kernel's range")
    J = len(jobs)
    score = torch.empty(J, dtype=torch.int32, device=dev)
    flags = torch.empty(J, dtype=torch.int32, device=dev)
    if J == 0:
        return score, flags
    fn, raw_stream, capturing = _lib_fns or _bind()
    d = dev.index
    args = (*(t.data_ptr() for t in tensors), jobs.order.data_ptr(), J,
            jobs.n_right, rows, gap_open, gap_extend, score.data_ptr(),
            flags.data_ptr(), raw_stream(d))
    if d == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(d):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"gapped_band launch failed: CUDA error {rc}")
    if capturing():
        banded_gapped_scores.captured += 1
    else:
        banded_gapped_scores.launches += 1
    return score, flags


banded_gapped_scores.launches = 0
banded_gapped_scores.captured = 0
