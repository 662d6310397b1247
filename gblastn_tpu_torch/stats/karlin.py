"""Karlin-Altschul statistics for nucleotide searches.

Faithful float64 reimplementation of the statistics engine of NCBI BLAST
(reference: NCBI c++/src/algo/blast/core/blast_stat.c), covering:

* the BLASTNA 16x16 score matrix built from reward/penalty
  (``BlastScoreBlkNuclMatrixCreate``, blast_stat.c:1036);
* score-frequency profiles (``BlastScoreFreqCalc``, blast_stat.c:2119);
* ungapped Karlin parameters lambda / H / K computed by safeguarded
  Newton iteration + the K dynamic program
  (``NlmKarlinLambdaNR`` blast_stat.c:2465, ``BlastKarlinLtoH`` :2580,
  ``BlastKarlinLHtoK`` :2221);
* the precomputed gapped parameter tables for supported reward/penalty
  pairs (``blastn_values_*``, blast_stat.c:590-705) with the gcd and
  infinite-gap-cost handling of ``s_GetNuclValuesArray`` (:3209) and
  ``Blast_KarlinBlkNuclGappedCalc`` (:3806).

These are pure host-side (NumPy / math) computations: they run once per
search setup, so there is nothing to gain from putting them on the TPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from gblastn_tpu_torch.io.encoding import BLASTNA_SIZE, BLASTNA_TO_NCBI4NA

BLAST_SCORE_MIN = -32768
BLAST_SCORE_MAX = 32767

_KARLIN_LAMBDA0 = 0.5
_KARLIN_LAMBDA_ACCURACY = 1.0e-5
_KARLIN_LAMBDA_ITER = 17
_K_SUMLIMIT = 0.0001
_K_ITER_MAX = 100

LN2 = math.log(2.0)


def _nint(x: float) -> int:
    """Round half away from zero, truncating like C's (long) cast."""
    x += 0.5 if x >= 0 else -0.5
    return int(x)  # int() truncates toward zero, matching (long)x


def _gcd(a: int, b: int) -> int:
    return math.gcd(abs(a), abs(b))


def _expm1(x: float) -> float:
    # BLAST_Expm1 (ncbi_math.c:38) uses a Taylor series below |x|=.33; the
    # difference from math.expm1 is < 1 ulp, so use the libm version.
    return math.expm1(x)


@dataclass(frozen=True)
class KarlinBlock:
    """lambda/K/H triple (Blast_KarlinBlk, blast_stat.h)."""

    Lambda: float
    K: float
    H: float

    @property
    def logK(self) -> float:
        return math.log(self.K)


def nucl_score_matrix(reward: int, penalty: int) -> np.ndarray:
    """16x16 BLASTNA score matrix (BlastScoreBlkNuclMatrixCreate)."""
    m = np.zeros((BLASTNA_SIZE, BLASTNA_SIZE), dtype=np.int64)
    degeneracy = np.zeros(BLASTNA_SIZE, dtype=np.int64)
    for i in range(4):
        degeneracy[i] = 1
    for i in range(4, BLASTNA_SIZE):
        degeneracy[i] = sum(
            1 for j in range(4) if BLASTNA_TO_NCBI4NA[i] & BLASTNA_TO_NCBI4NA[j]
        )
    for i in range(BLASTNA_SIZE):
        for j in range(i, BLASTNA_SIZE):
            if BLASTNA_TO_NCBI4NA[i] & BLASTNA_TO_NCBI4NA[j]:
                s = _nint(((degeneracy[j] - 1) * penalty + reward) / degeneracy[j])
            else:
                s = penalty
            m[i, j] = s
            m[j, i] = s
    # Row/column 15 is the context gap sentinel.
    m[BLASTNA_SIZE - 1, :] = -(2**31) // 2
    m[:, BLASTNA_SIZE - 1] = -(2**31) // 2
    return m


def _matrix_score_range(matrix: np.ndarray) -> tuple[int, int]:
    """(loscore, hiscore) ignoring sentinel scores (BlastScoreBlkMaxScoreSet)."""
    vals = matrix[(matrix > BLAST_SCORE_MIN) & (matrix < BLAST_SCORE_MAX)]
    lo = max(int(vals.min()), BLAST_SCORE_MIN)
    hi = min(int(vals.max()), BLAST_SCORE_MAX)
    return lo, hi


def score_frequencies(
    matrix: np.ndarray,
    query_freqs: np.ndarray,
    subject_freqs: np.ndarray,
) -> tuple[np.ndarray, int, int, float]:
    """Score probability profile (BlastScoreFreqCalc, blast_stat.c:2119).

    Returns (sprob indexed from loscore, obs_min, obs_max, score_avg); sprob
    array covers [loscore, hiscore] inclusive.
    """
    lo, hi = _matrix_score_range(matrix)
    sprob = np.zeros(hi - lo + 1, dtype=np.float64)
    for i in range(BLASTNA_SIZE):
        if query_freqs[i] == 0.0:
            continue
        for j in range(BLASTNA_SIZE):
            s = int(matrix[i, j])
            if s >= lo:
                sprob[s - lo] += query_freqs[i] * subject_freqs[j]
    nz = np.nonzero(sprob > 0.0)[0]
    if len(nz) == 0:
        return sprob, lo, lo, 0.0
    obs_min = lo + int(nz[0])
    obs_max = lo + int(nz[-1])
    ssum = float(sprob.sum())
    score_avg = 0.0
    if abs(ssum) > 0.0001:
        sprob /= ssum
        scores = np.arange(lo, hi + 1, dtype=np.float64)
        score_avg = float((scores * sprob).sum())
    return sprob, obs_min, obs_max, score_avg


def std_nucl_freqs() -> np.ndarray:
    """Uniform 25% ACGT (nt_prob, blast_stat.c:1794)."""
    f = np.zeros(BLASTNA_SIZE, dtype=np.float64)
    f[:4] = 0.25
    return f


def query_residue_freqs(query_blastna: np.ndarray) -> np.ndarray:
    """Residue frequencies of a query, ambiguous residues not counted
    (BlastResCompStr + Blast_ResFreqResComp, blast_stat.c:1990-2080).

    NCBI registers 'N' (BLASTNA 14) as the ambiguous residue for blastn and
    also never counts the gap sentinel (15).
    """
    counts = np.bincount(np.asarray(query_blastna, dtype=np.int64), minlength=BLASTNA_SIZE)
    counts = counts.astype(np.float64)
    counts[14] = 0.0  # ambiguous residue N
    counts[15] = 0.0  # sentinel
    total = counts.sum()
    if total == 0:
        return std_nucl_freqs()
    return counts / total


def karlin_lambda_nr(
    sprob: np.ndarray, lo: int, obs_min: int, obs_max: int, score_avg: float,
    lambda0: float = _KARLIN_LAMBDA0,
) -> float:
    """Solve sum p_i e^(lambda i) = 1 (NlmKarlinLambdaNR, blast_stat.c:2465)."""
    if score_avg >= 0.0:
        return -1.0
    low, high = obs_min, obs_max
    if low >= 0 or high <= 0:
        return -1.0

    # probs indexed by score: probs[s] for s in [low, high]
    def p(s: int) -> float:
        return float(sprob[s - lo])

    d = -low
    for i in range(1, high - low + 1):
        if d <= 1:
            break
        if p(low + i) != 0.0:
            d = _gcd(d, i)

    tolx = _KARLIN_LAMBDA_ACCURACY
    itmax = 20
    max_newton = 20 + _KARLIN_LAMBDA_ITER

    x0 = math.exp(-lambda0)
    x = x0 if 0 < x0 < 1 else 0.5
    a, b = 0.0, 1.0
    f = 4.0
    is_newton = False
    k = 0
    for k in range(itmax):
        fold = f
        was_newton = is_newton
        is_newton = False
        # Horner evaluation of f and derivative g
        g = 0.0
        f = p(low)
        i = low + d
        while i < 0:
            g = x * g + f
            f = f * x + p(i)
            i += d
        g = x * g + f
        f = f * x + p(0) - 1.0
        i = d
        while i <= high:
            g = x * g + f
            f = f * x + p(i)
            i += d
        if f > 0:
            a = x
        elif f < 0:
            b = x
        else:
            break
        if b - a < 2 * a * (1 - b) * tolx:
            x = (a + b) / 2
            break
        if (
            k >= max_newton
            or (was_newton and abs(f) > 0.9 * abs(fold))
            or g >= 0
        ):
            x = (a + b) / 2
        else:
            pstep = -f / g
            y = x + pstep
            if y <= a or y >= b:
                x = (a + b) / 2
            else:
                is_newton = True
                x = y
                if abs(pstep) < tolx * x * (1 - x):
                    break
    return -math.log(x) / d


def karlin_lto_h(sprob: np.ndarray, lo: int, obs_min: int, obs_max: int,
                 lam: float) -> float:
    """Relative entropy H (BlastKarlinLtoH, blast_stat.c:2580)."""
    if lam < 0:
        return -1.0
    low, high = obs_min, obs_max
    etonlam = math.exp(-lam)
    s = low * float(sprob[low - lo])
    for score in range(low + 1, high + 1):
        s = score * float(sprob[score - lo]) + etonlam * s
    scale = etonlam**high
    if scale > 0.0:
        return lam * s / scale
    return lam * math.exp(lam * high + math.log(s))


def karlin_lh_to_k(sprob: np.ndarray, lo: int, obs_min: int, obs_max: int,
                   score_avg: float, lam: float, H: float) -> float:
    """Parameter K (BlastKarlinLHtoK, blast_stat.c:2221)."""
    if lam <= 0.0 or H <= 0.0 or score_avg >= 0.0:
        return -1.0
    low, high = obs_min, obs_max

    def p(s: int) -> float:
        v = sprob[s - lo]
        return float(v)

    divisor = -low
    for i in range(1, high - low + 1):
        if divisor <= 1:
            break
        if p(low + i) != 0.0:
            divisor = _gcd(divisor, i)

    high_d = high // divisor
    low_d = low // divisor
    lam_d = lam * divisor
    range_d = high_d - low_d

    first_term = H / lam_d
    exp_minus_lambda = math.exp(-lam_d)

    if low_d == -1 and high_d == 1:
        pl = p(low_d * divisor)
        ph = p(high_d * divisor)
        return (pl - ph) * (pl - ph) / pl

    if low_d == -1 or high_d == 1:
        if high_d != 1:
            sa = score_avg / divisor
            first_term = (sa * sa) / first_term
        return first_term * (1.0 - exp_minus_lambda)

    sumlimit = _K_SUMLIMIT
    iterlimit = _K_ITER_MAX
    # probabilities of alignment scores, index 0 == lowest possible score
    asp = np.zeros(iterlimit * range_d + 1, dtype=np.float64)
    # Reindexed probability access: probs at multiples of divisor
    probs_low = np.array(
        [p((low_d + i) * divisor) for i in range(range_d + 1)], dtype=np.float64
    )

    outer_sum = 0.0
    low_score = high_score = 0
    asp[0] = inner_sum = oldsum = oldsum2 = 1.0
    iter_counter = 0
    while iter_counter < iterlimit and inner_sum > sumlimit:
        first = last = range_d
        low_score += low_d
        high_score += high_d
        # dynamic program over asp[0 .. high_score-low_score]
        for idx in range(high_score - low_score, -1, -1):
            inner = 0.0
            j1 = idx - first
            j1e = idx - last
            j2 = first
            while j1 >= j1e:
                inner += asp[j1] * probs_low[j2]
                j1 -= 1
                j2 += 1
            if first:
                first -= 1
            if idx <= range_d:
                last -= 1
            asp[idx] = inner
        # Note: the C loop writes innerSum into *ptrP as it decrements; the
        # final store after loop exit lands one below index 0 and is then
        # re-read by the Horner stage via *++ptrP, i.e. asp[0].
        inner_sum = asp[0]
        i = low_score + 1
        idx = 0
        while i < 0:
            idx += 1
            inner_sum = asp[idx] + inner_sum * exp_minus_lambda
            i += 1
        inner_sum *= exp_minus_lambda
        while i <= high_score:
            idx += 1
            inner_sum += asp[idx]
            i += 1
        oldsum2 = oldsum
        oldsum = inner_sum
        iter_counter += 1
        # C: outerSum += innerSum /= ++iterCounter -- the division feeds the
        # next loop-condition test as well.
        inner_sum /= iter_counter
        outer_sum += inner_sum

    del oldsum, oldsum2
    return -math.exp(-2.0 * outer_sum) / (first_term * _expm1(-lam_d))


@lru_cache(maxsize=64)
def ungapped_karlin_block(
    reward: int, penalty: int, query_freq_key: tuple | None = None
) -> KarlinBlock:
    """Ungapped Karlin block (Blast_KarlinBlkUngappedCalc path).

    ``query_freq_key`` is an optional tuple of 16 floats (query residue
    frequencies); None means the ideal uniform composition. For pure-ACGT
    queries the result is composition independent.
    """
    matrix = nucl_score_matrix(reward, penalty)
    lo, _ = _matrix_score_range(matrix)
    qf = np.array(query_freq_key, dtype=np.float64) if query_freq_key else std_nucl_freqs()
    sprob, obs_min, obs_max, avg = score_frequencies(matrix, qf, std_nucl_freqs())
    lam = karlin_lambda_nr(sprob, lo, obs_min, obs_max, avg)
    if lam < 0:
        raise ValueError("invalid score system: expected score non-negative")
    H = karlin_lto_h(sprob, lo, obs_min, obs_max, lam)
    K = karlin_lh_to_k(sprob, lo, obs_min, obs_max, avg, lam, H)
    return KarlinBlock(Lambda=lam, K=K, H=H)
