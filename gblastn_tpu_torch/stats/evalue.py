"""E-values, bit scores, cutoffs and effective search space.

Reimplements (host-side, float64):
* ``BLAST_ComputeLengthAdjustment``  (blast_stat.c:4994)
* ``BLAST_CalcEffLengths``           (blast_setup.c:638)
* ``BLAST_KarlinStoE_simple``        (blast_stat.c:4111) - E-value from score
* ``BlastKarlinEtoS_simple``         (blast_stat.c:3994) - score from E-value
* ``BLAST_Cutoffs``                  (blast_stat.c:4044)
* ``BLAST_GapDecayDivisor``          (blast_stat.c:4033)
* bit score conversion               (Blast_HSPListGetBitScores, blast_hits.c:1740)
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from gblastn_tpu_torch.stats.karlin import BLAST_SCORE_MIN, LN2, KarlinBlock

_SMALL_FLOAT = 1.0e-297


def compute_length_adjustment(
    K: float, logK: float, alpha_d_lambda: float, beta: float,
    query_length: int, db_length: int, db_num_seqs: int,
) -> int:
    """Iterative length adjustment (BLAST_ComputeLengthAdjustment)."""
    k_max_iter = 20
    m = float(query_length)
    n = float(db_length)
    N = float(db_num_seqs)

    a = N
    mb = m * N + n
    c = n * m - max(m, n) / K
    if c < 0:
        return 0
    ell_max = 2 * c / (mb + math.sqrt(mb * mb - 4 * a * c))

    ell_min = 0.0
    ell_next = 0.0
    converged = False
    ell = 0.0
    for i in range(1, k_max_iter + 1):
        ell = ell_next
        ss = (m - ell) * (n - N * ell)
        ell_bar = alpha_d_lambda * (logK + math.log(ss)) + beta
        if ell_bar >= ell:
            ell_min = ell
            if ell_bar - ell_min <= 1.0:
                converged = True
                break
            if ell_min == ell_max:
                break
        else:
            ell_max = ell
        if ell_min <= ell_bar <= ell_max:
            ell_next = ell_bar
        else:
            ell_next = ell_max if i == 1 else (ell_min + ell_max) / 2

    if converged:
        length_adjustment = int(ell_min)
        ell = math.ceil(ell_min)
        if ell <= ell_max:
            ss = (m - ell) * (n - N * ell)
            if alpha_d_lambda * (logK + math.log(ss)) + beta >= ell:
                length_adjustment = int(ell)
    else:
        length_adjustment = int(ell_min)
    return length_adjustment


@dataclass(frozen=True)
class EffectiveLengths:
    length_adjustment: int
    eff_searchsp: int


def effective_search_space(
    kbp_gap: KarlinBlock, alpha: float, beta: float,
    query_length: int, db_length: int, db_num_seqs: int,
    searchsp_override: int = 0,
) -> EffectiveLengths:
    """Per-context effective search space (BLAST_CalcEffLengths core)."""
    length_adjustment = compute_length_adjustment(
        kbp_gap.K, kbp_gap.logK, alpha / kbp_gap.Lambda, beta,
        query_length, db_length, db_num_seqs,
    )
    if searchsp_override > 0:
        return EffectiveLengths(length_adjustment, searchsp_override)
    effective_db_length = db_length - db_num_seqs * length_adjustment
    if effective_db_length <= 0:
        effective_db_length = 1
    searchsp = effective_db_length * (query_length - length_adjustment)
    return EffectiveLengths(length_adjustment, searchsp)


def karlin_stoe(score: int, kbp: KarlinBlock, searchsp: int) -> float:
    """E-value from raw score (BLAST_KarlinStoE_simple)."""
    if kbp.Lambda < 0 or kbp.K < 0 or kbp.H < 0:
        return -1.0
    return float(searchsp) * math.exp(-kbp.Lambda * score + kbp.logK)


def karlin_etos(E: float, kbp: KarlinBlock, searchsp: int) -> int:
    """Score from E-value (BlastKarlinEtoS_simple)."""
    if kbp.Lambda < 0 or kbp.K < 0 or kbp.H < 0:
        return BLAST_SCORE_MIN
    E = max(E, _SMALL_FLOAT)
    return int(math.ceil(math.log(kbp.K * searchsp / E) / kbp.Lambda))


def gap_decay_divisor(decayrate: float, nsegs: int = 1) -> float:
    return (1.0 - decayrate) * decayrate ** (nsegs - 1)


def blast_cutoffs(
    S: int, E: float, kbp: KarlinBlock, searchsp: int,
    dodecay: bool = False, gap_decay_rate: float = 0.0,
) -> tuple[int, float]:
    """Cutoff score + adjusted expect (BLAST_Cutoffs). Returns (S, E)."""
    if kbp.Lambda == -1.0 or kbp.K == -1.0 or kbp.H == -1.0:
        raise ValueError("invalid Karlin block")
    s = S
    e = E
    esave = e
    s_changed = False
    if e > 0.0:
        if dodecay and 0 < gap_decay_rate < 1:
            e *= gap_decay_divisor(gap_decay_rate, 1)
        es = karlin_etos(e, kbp, searchsp)
    else:
        es = 1
    if es > s:
        s_changed = True
        s = es
    if esave <= 0.0 or not s_changed:
        e = karlin_stoe(s, kbp, searchsp)
        if dodecay and 0 < gap_decay_rate < 1:
            e /= gap_decay_divisor(gap_decay_rate, 1)
    else:
        e = esave
    return s, e


def bit_score(score: int, kbp: KarlinBlock) -> float:
    """(score*lambda - logK) / ln2  (Blast_HSPListGetBitScores)."""
    return (score * kbp.Lambda - kbp.logK) / LN2
