"""The plain reference: optimal alignment scores by dynamic programming.

Plain PyTorch, batched over pairs of sequences (2-bit codes, 0-3), on any
device. It implements the scoring that a configuration states (match and
mismatch scores, a gap of length L costing ``gap_open + L * gap_extend``),
with no heuristic: no seeds, no X-drop, no band.

- ``local_scores``: the best local alignment score of each pair
  (Smith-Waterman with affine gaps, Gotoh).
- ``global_scores``: the best score of an alignment that spans both
  sequences of each pair end to end (Needleman-Wunsch with affine gaps).
- ``ungapped_best``: the best gap-free local segment of each pair, with
  its ends (the control's alignment).
- ``raw_score`` and ``bit_score``: NCBI BLAST's mapping from the DP score
  to the reported raw score and bit score (``scale`` undoes the doubled
  units of megablast's non-affine gap cost, ``round_even`` is blastn's
  rounding of odd scores down; Karlin-Altschul lambda and K from the
  configuration).

The DP runs row by row over the first sequence. Within a row the
horizontal gaps are one running maximum (``torch.cummax``): with
``gap_open >= 0`` a cell reached by a horizontal gap never opens a better
one, so ``E[j] = max_{k<j} (H'[k] + k * ext) - j * ext - open``, where
``H'`` is the row before horizontal gaps.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG = -(1 << 22)          # a score no alignment reaches
PAD_Q, PAD_S = 4, 5       # padding codes: they match nothing
CHUNK = 2048              # pairs a DP pass


def raw_score(dp_score, scoring):
    """The raw score BLAST reports for a DP score in ``scoring``'s units."""
    raw = int(dp_score) // int(scoring.get("scale", 1))
    if scoring.get("round_even"):
        raw &= ~1
    return raw


def bit_score(raw, karlin):
    """Bit score of a raw score: (lambda S - ln K) / ln 2."""
    return (karlin["lambda"] * raw - math.log(karlin["K"])) / math.log(2.0)


def bit_score_text(bits):
    """NCBI's tabular bit-score text (align_format_util.cpp, GetScoreString)."""
    if bits > 9999:
        return f"{bits:.3e}"
    if bits > 99.9:
        return f"{int(bits):4d}"
    return f"{bits:4.1f}"


def _pad(seqs, code, device):
    n = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), max(n, 1)), code, np.int8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return torch.from_numpy(out).to(device)


def _row_scores(qi, S, scoring):
    """Substitution scores of query column ``qi`` [B] against ``S`` [B, L]."""
    same = qi[:, None] == S
    sc = torch.where(same, scoring["match"], scoring["mismatch"])
    bad = (S >= 4) | (qi[:, None] >= 4)
    return torch.where(bad, NEG, sc).to(torch.int32)


def _dp(qs, ss, scoring, local, device):
    """One DP pass over pairs (qs[b], ss[b]); local best or global end
    score per pair (int64 numpy)."""
    B = len(qs)
    Q = _pad(qs, PAD_Q, device)
    S = _pad(ss, PAD_S, device)
    qlen = torch.tensor([len(q) for q in qs], device=device)
    slen = torch.tensor([len(s) for s in ss], device=device)
    go, ge = int(scoring["gap_open"]), int(scoring["gap_extend"])
    L = S.shape[1]
    j = torch.arange(L + 1, device=device, dtype=torch.int32)
    if local:
        H = torch.zeros(B, L + 1, dtype=torch.int32, device=device)
    else:
        H = torch.where(j > 0, -(go + j * ge), 0).to(torch.int32)
        H = H.expand(B, L + 1).clone()
    F = torch.full((B, L), NEG, dtype=torch.int32, device=device)
    best = torch.zeros(B, dtype=torch.int32, device=device)
    ans = H.gather(1, slen[:, None]).squeeze(1)      # qlen == 0
    for i in range(1, Q.shape[1] + 1):
        sc = _row_scores(Q[:, i - 1], S, scoring)
        F = torch.maximum(F - ge, H[:, 1:] - go - ge)
        Hp = torch.maximum(H[:, :-1] + sc, F)
        if local:
            Hp = torch.clamp_min(Hp, 0)
            col0 = torch.zeros(B, 1, dtype=torch.int32, device=device)
        else:
            col0 = torch.full((B, 1), -(go + i * ge), dtype=torch.int32,
                              device=device)
        full = torch.cat([col0, Hp], 1)
        run = torch.cummax(full + j * ge, 1).values
        E = run[:, :-1] - j[1:] * ge - go
        H = torch.cat([col0, torch.maximum(Hp, E)], 1)
        if local:
            best = torch.maximum(best, H.max(1).values)
        else:
            ans = torch.where(qlen == i,
                              H.gather(1, slen[:, None]).squeeze(1), ans)
    out = best if local else ans
    return out.to(torch.int64).cpu().numpy()


def _chunked(fn, qs, ss, *args):
    parts = [fn(qs[a:a + CHUNK], ss[a:a + CHUNK], *args)
             for a in range(0, len(qs), CHUNK)]
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def local_scores(qs, ss, scoring, device="cpu"):
    """Best local alignment score of each pair, in ``scoring``'s units."""
    return _chunked(_dp, qs, ss, scoring, True, device)


def global_scores(qs, ss, scoring, device="cpu"):
    """Best end-to-end alignment score of each pair, in ``scoring``'s
    units (an empty pair scores 0)."""
    return _chunked(_dp, qs, ss, scoring, False, device)


def _ungapped(qs, ss, scoring, device):
    B = len(qs)
    Q = _pad(qs, PAD_Q, device)
    S = _pad(ss, PAD_S, device)
    L = S.shape[1]
    H = torch.zeros(B, L + 1, dtype=torch.int32, device=device)
    start = torch.zeros(B, L + 1, dtype=torch.int32, device=device)
    best = torch.zeros(B, dtype=torch.int32, device=device)
    b_end_i = torch.zeros(B, dtype=torch.int32, device=device)
    b_end_j = torch.zeros(B, dtype=torch.int32, device=device)
    b_start = torch.zeros(B, dtype=torch.int32, device=device)
    zero = torch.zeros(B, 1, dtype=torch.int32, device=device)
    for i in range(1, Q.shape[1] + 1):
        sc = _row_scores(Q[:, i - 1], S, scoring)
        d = H[:, :-1] + sc
        keep = d > 0
        Hn = torch.where(keep, d, 0)
        st = torch.where(keep, start[:, :-1], i)   # the run's 0-based q start
        H = torch.cat([zero, Hn], 1)
        start = torch.cat([zero + i, st], 1)
        m, arg = Hn.max(1)
        better = m > best
        best = torch.where(better, m, best)
        b_end_i = torch.where(better, i, b_end_i)
        b_end_j = torch.where(better, arg.to(torch.int32) + 1, b_end_j)
        b_start = torch.where(better, st.gather(1, arg[:, None]).squeeze(1),
                              b_start)
    s0 = b_end_j - (b_end_i - b_start)
    cols = [best, b_start, b_end_i, s0, b_end_j]
    return torch.stack(cols, 1).to(torch.int64).cpu().numpy()


def ungapped_best(qs, ss, scoring, device="cpu"):
    """Best gap-free local segment of each pair: int64 [B, 5] of (score,
    q_start, q_end, s_start, s_end), 0-based and half-open; a pair with
    no positive segment reads score 0."""
    parts = [_ungapped(qs[a:a + CHUNK], ss[a:a + CHUNK], scoring, device)
             for a in range(0, len(qs), CHUNK)]
    return np.concatenate(parts) if parts else np.zeros((0, 5), np.int64)
