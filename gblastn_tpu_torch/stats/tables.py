"""Precomputed gapped Karlin-Altschul parameters for nucleotide scoring.

The values below are the published NCBI parameter tables for supported
(reward, penalty) pairs (reference: blastn_values_* arrays,
NCBI c++/src/algo/blast/core/blast_stat.c:590-705), with the
selection/gcd/infinite-gap-cost logic of ``s_GetNuclValuesArray`` (:3209),
``Blast_KarlinBlkNuclGappedCalc`` (:3806) and ``Blast_GetNuclAlphaBeta``
(:3919).

Each row: (gap_open, gap_extend, lambda, K, H, alpha, beta, theta).
A leading row with gap costs (0, 0) holds the parameters for the
"non-affine" (greedy / linear gap cost) regime used by megablast.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from gblastn_tpu_torch.stats.karlin import KarlinBlock, ungapped_karlin_block

_TABLES: dict[tuple[int, int], tuple[list[list[float]], int, int, bool]] = {
    # (reward, penalty): (rows, gap_open_max, gap_extend_max, round_down)
    (1, -5): (
        [
            [0, 0, 1.39, 0.747, 1.38, 1.00, 0, 100],
            [3, 3, 1.39, 0.747, 1.38, 1.00, 0, 100],
        ],
        3, 3, False,
    ),
    (1, -4): (
        [
            [0, 0, 1.383, 0.738, 1.36, 1.02, 0, 100],
            [1, 2, 1.36, 0.67, 1.2, 1.1, 0, 98],
            [0, 2, 1.26, 0.43, 0.90, 1.4, -1, 91],
            [2, 1, 1.35, 0.61, 1.1, 1.2, -1, 98],
            [1, 1, 1.22, 0.35, 0.72, 1.7, -3, 88],
        ],
        2, 2, False,
    ),
    (2, -7): (
        [
            [0, 0, 0.69, 0.73, 1.34, 0.515, 0, 100],
            [2, 4, 0.68, 0.67, 1.2, 0.55, 0, 99],
            [0, 4, 0.63, 0.43, 0.90, 0.7, -1, 91],
            [4, 2, 0.675, 0.62, 1.1, 0.6, -1, 98],
            [2, 2, 0.61, 0.35, 0.72, 1.7, -3, 88],
        ],
        4, 4, True,
    ),
    (1, -3): (
        [
            [0, 0, 1.374, 0.711, 1.31, 1.05, 0, 100],
            [2, 2, 1.37, 0.70, 1.2, 1.1, 0, 99],
            [1, 2, 1.35, 0.64, 1.1, 1.2, -1, 98],
            [0, 2, 1.25, 0.42, 0.83, 1.5, -2, 91],
            [2, 1, 1.34, 0.60, 1.1, 1.2, -1, 97],
            [1, 1, 1.21, 0.34, 0.71, 1.7, -2, 88],
        ],
        2, 2, False,
    ),
    (2, -5): (
        [
            [0, 0, 0.675, 0.65, 1.1, 0.6, -1, 99],
            [2, 4, 0.67, 0.59, 1.1, 0.6, -1, 98],
            [0, 4, 0.62, 0.39, 0.78, 0.8, -2, 91],
            [4, 2, 0.67, 0.61, 1.0, 0.65, -2, 98],
            [2, 2, 0.56, 0.32, 0.59, 0.95, -4, 82],
        ],
        4, 4, True,
    ),
    (1, -2): (
        [
            [0, 0, 1.28, 0.46, 0.85, 1.5, -2, 96],
            [2, 2, 1.33, 0.62, 1.1, 1.2, 0, 99],
            [1, 2, 1.30, 0.52, 0.93, 1.4, -2, 97],
            [0, 2, 1.19, 0.34, 0.66, 1.8, -3, 89],
            [3, 1, 1.32, 0.57, 1.0, 1.3, -1, 99],
            [2, 1, 1.29, 0.49, 0.92, 1.4, -1, 96],
            [1, 1, 1.14, 0.26, 0.52, 2.2, -5, 85],
        ],
        2, 2, False,
    ),
    (2, -3): (
        [
            [0, 0, 0.55, 0.21, 0.46, 1.2, -5, 87],
            [4, 4, 0.63, 0.42, 0.84, 0.75, -2, 99],
            [2, 4, 0.615, 0.37, 0.72, 0.85, -3, 97],
            [0, 4, 0.55, 0.21, 0.46, 1.2, -5, 87],
            [3, 3, 0.615, 0.37, 0.68, 0.9, -3, 97],
            [6, 2, 0.63, 0.42, 0.84, 0.75, -2, 99],
            [5, 2, 0.625, 0.41, 0.78, 0.8, -2, 99],
            [4, 2, 0.61, 0.35, 0.68, 0.9, -3, 96],
            [2, 2, 0.515, 0.14, 0.33, 1.55, -9, 81],
        ],
        6, 4, True,
    ),
    (3, -4): (
        [
            [6, 3, 0.389, 0.25, 0.56, 0.7, -5, 95],
            [5, 3, 0.375, 0.21, 0.47, 0.8, -6, 92],
            [4, 3, 0.351, 0.14, 0.35, 1.0, -9, 86],
            [6, 2, 0.362, 0.16, 0.45, 0.8, -4, 88],
            [5, 2, 0.330, 0.092, 0.28, 1.2, -13, 81],
            [4, 2, 0.281, 0.046, 0.16, 1.8, -23, 69],
        ],
        6, 3, True,
    ),
    (4, -5): (
        [
            [0, 0, 0.22, 0.061, 0.22, 1.0, -15, 74],
            [6, 5, 0.28, 0.21, 0.47, 0.6, -7, 93],
            [5, 5, 0.27, 0.17, 0.39, 0.7, -9, 90],
            [4, 5, 0.25, 0.10, 0.31, 0.8, -10, 83],
            [3, 5, 0.23, 0.065, 0.25, 0.9, -11, 76],
        ],
        12, 8, False,
    ),
    (1, -1): (
        [
            [3, 2, 1.09, 0.31, 0.55, 2.0, -2, 99],
            [2, 2, 1.07, 0.27, 0.49, 2.2, -3, 97],
            [1, 2, 1.02, 0.21, 0.36, 2.8, -6, 92],
            [0, 2, 0.80, 0.064, 0.17, 4.8, -16, 72],
            [4, 1, 1.08, 0.28, 0.54, 2.0, -2, 98],
            [3, 1, 1.06, 0.25, 0.46, 2.3, -4, 96],
            [2, 1, 0.99, 0.17, 0.30, 3.3, -10, 90],
        ],
        4, 2, False,
    ),
    (3, -2): (
        [[5, 5, 0.208, 0.030, 0.072, 2.9, -47, 77]],
        5, 5, False,
    ),
    (5, -4): (
        [
            [10, 6, 0.163, 0.068, 0.16, 1.0, -19, 85],
            [8, 6, 0.146, 0.039, 0.11, 1.3, -29, 76],
        ],
        25, 10, False,
    ),
}


@dataclass(frozen=True)
class NuclGappedParams:
    kbp: KarlinBlock
    alpha: float
    beta: float
    round_down: bool


class UnsupportedScoringError(ValueError):
    pass


def _get_values(reward: int, penalty: int):
    """s_GetNuclValuesArray: gcd reduction + table selection + gcd re-scale.

    Returns (normal_rows, linear_row_or_None, gap_open_max, gap_extend_max,
    round_down) with gap costs scaled back by the gcd divisor and
    lambda/alpha divided by it.
    """
    divisor = math.gcd(abs(reward), abs(penalty))
    r, p = reward // divisor, penalty // divisor
    key = (r, p)
    if key not in _TABLES:
        raise UnsupportedScoringError(
            f"Substitution scores {reward} and {penalty} are not supported"
        )
    rows, go_max, ge_max, round_down = _TABLES[key]
    rows = [list(row) for row in rows]
    linear = None
    if rows[0][0] == 0 and rows[0][1] == 0:
        linear = rows[0]
        rows = rows[1:]
    go_max *= divisor
    ge_max *= divisor
    if divisor != 1:
        for row in rows:
            row[0] *= divisor
            row[1] *= divisor
            row[2] /= divisor
            row[5] /= divisor
        if linear is not None:
            linear[0] *= divisor
            linear[1] *= divisor
            linear[2] /= divisor
            linear[5] /= divisor
    return rows, linear, go_max, ge_max, round_down


def gapped_karlin_block(
    reward: int, penalty: int, gap_open: int, gap_extend: int,
    kbp_ungap: KarlinBlock | None = None,
) -> tuple[KarlinBlock, bool]:
    """Gapped Karlin block lookup (Blast_KarlinBlkNuclGappedCalc).

    gap_open == gap_extend == 0 selects the non-affine (greedy/megablast)
    regime. Gap costs at or above the table maxima use ungapped parameters.
    Returns (KarlinBlock, round_down).
    """
    rows, linear, go_max, ge_max, round_down = _get_values(reward, penalty)
    if gap_open == 0 and gap_extend == 0 and linear is not None:
        return KarlinBlock(Lambda=linear[2], K=linear[3], H=linear[4]), round_down
    for row in rows:
        if row[0] == gap_open and row[1] == gap_extend:
            return KarlinBlock(Lambda=row[2], K=row[3], H=row[4]), round_down
    if gap_open >= go_max and gap_extend >= ge_max:
        kbp = kbp_ungap or ungapped_karlin_block(reward, penalty)
        return kbp, round_down
    raise UnsupportedScoringError(
        f"Gap existence and extension values {gap_open} and {gap_extend} are "
        f"not supported for substitution scores {reward} and {penalty}"
    )


def _ungapped_beta(reward: int, penalty: int) -> float:
    """s_GetUngappedBeta, blast_stat.c:3907."""
    if (reward == 1 and penalty == -1) or (reward == 2 and penalty == -3):
        return -2.0
    return 0.0


def nucl_alpha_beta(
    reward: int, penalty: int, gap_open: int, gap_extend: int,
    gapped: bool, kbp_ungap: KarlinBlock | None = None,
) -> tuple[float, float]:
    """Blast_GetNuclAlphaBeta (blast_stat.c:3919)."""
    try:
        rows, linear, _go, _ge, _rd = _get_values(reward, penalty)
    except UnsupportedScoringError:
        rows, linear = [], None
    if gapped:
        if gap_open == 0 and gap_extend == 0 and linear is not None:
            return linear[5], linear[6]
        for row in rows:
            if row[0] == gap_open and row[1] == gap_extend:
                return row[5], row[6]
    kbp = kbp_ungap or ungapped_karlin_block(reward, penalty)
    return kbp.Lambda / kbp.H, _ungapped_beta(reward, penalty)
