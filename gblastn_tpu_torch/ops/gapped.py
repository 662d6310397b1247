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

from dataclasses import dataclass

import torch

NEG = -(1 << 24)
NEGH = NEG // 2
W = 128                 # band width (diagonals)
HALF = W // 2
STEP = 8                # rows per X-drop / death group

FLAG_EDGE = 1
FLAG_ROWS = 2


@dataclass
class GappedJobs:
    """One launch's jobs: right extensions of every seed, then left ones."""

    a0: torch.Tensor        # int64[J] subject seed point
    b0: torch.Tensor        # int64[J] query seed point
    m: torch.Tensor         # int32[J] subject steps (rows)
    n: torch.Tensor         # int32[J] query steps (columns)
    x: torch.Tensor         # int32[J] X-drop (kernel score scale)
    n_right: int            # jobs [0, n_right) are right, the rest left

    def __len__(self) -> int:
        return int(self.m.shape[0])


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


def banded_gapped_scores_ref(query, subject2, matrix16, jobs: GappedJobs,
                             *, rows: int, gap_open: int, gap_extend: int,
                             return_cells: bool = False):
    """Plain PyTorch version of K2 (same arguments and results as
    ``banded_gapped_scores``). With ``return_cells`` it also returns the
    cells each job computed (int64[J]): the band cells with column j in
    [0, N] of every row before the job died or ran out, the work count
    behind K2's bound."""
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


def _check_kernel_args(query, subject2, matrix16, jobs: GappedJobs,
                       rows: int):
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
    for name, t, dt in (("a0", jobs.a0, torch.int64),
                        ("b0", jobs.b0, torch.int64),
                        ("m", jobs.m, torch.int32),
                        ("n", jobs.n, torch.int32),
                        ("x", jobs.x, torch.int32)):
        if (t.device != dev or t.dtype != dt or t.dim() != 1
                or t.numel() != J or not t.is_contiguous()):
            raise ValueError(f"jobs.{name}: want contiguous 1-D {dt} of "
                             f"length {J} on {dev}")
    if not J:
        return
    # every row and column a job may read lies inside subject and query
    right = torch.arange(J, device=dev) < jobs.n_right
    work = (jobs.m > 0) & (jobs.n > 0)
    r = torch.minimum(jobs.m.long(), torch.full_like(jobs.a0, rows))
    n = jobs.n.long()
    a_lo = torch.where(right, jobs.a0, jobs.a0 - r)
    a_hi = torch.where(right, jobs.a0 + r, jobs.a0)
    b_lo = torch.where(right, jobs.b0, jobs.b0 - n)
    b_hi = torch.where(right, jobs.b0 + n, jobs.b0)
    bad = work & ((a_lo < 0) | (a_hi > subject2.numel()) | (b_lo < 0)
                  | (b_hi > query.numel()))
    if bool(bad.any()):
        raise ValueError("a gapped job reaches outside query or subject")


def banded_gapped_scores(query, subject2, matrix16, jobs: GappedJobs, *,
                         rows: int, gap_open: int, gap_extend: int):
    """K2: score-only banded gapped DP of every job.

    query uint8[Q] BLASTNA codes, subject2 int8[S] 2-bit codes, matrix16
    int32[16, 4] (query code x subject code, kernel score scale), and the
    jobs of ``gapped_jobs``. Returns int32 (score, flags) per job. CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream (and count the launch in
    ``banded_gapped_scores.launches``)."""
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
    from gblastn_tpu_torch.ops import _build

    J = len(jobs)
    score = torch.empty(J, dtype=torch.int32, device=dev)
    flags = torch.empty(J, dtype=torch.int32, device=dev)
    if J == 0:
        return score, flags
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gblastn_gapped_band(
            *(t.data_ptr() for t in tensors), J, jobs.n_right, rows,
            gap_open, gap_extend, score.data_ptr(), flags.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"gapped_band launch failed: CUDA error {rc}")
    banded_gapped_scores.launches += 1
    return score, flags


banded_gapped_scores.launches = 0
