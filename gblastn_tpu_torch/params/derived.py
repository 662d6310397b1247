"""Derived per-context search parameters (cutoffs, raw X-drops).

Reimplements the "parameters" layer of the reference engine
(reference: NCBI c++/src/algo/blast/core/blast_parameters.c):

* ``BlastHitSavingParametersUpdate`` (:823) -- gapped cutoff score per
  context from the e-value threshold and effective search space;
* ``BlastInitialWordParametersNew/Update`` (:161/:281) -- ungapped cutoff
  (gap trigger), raw ungapped X-drop, reduced nucleotide cutoff;
* ``BlastExtensionParametersNew`` (:415) -- raw gapped X-drops.

All scores here are raw integer scores; options carry bit values.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from gblastn_tpu_torch.params.options import SearchOptions
from gblastn_tpu_torch.stats.evalue import blast_cutoffs, effective_search_space
from gblastn_tpu_torch.stats.karlin import LN2, KarlinBlock, ungapped_karlin_block
from gblastn_tpu_torch.stats.tables import gapped_karlin_block, nucl_alpha_beta

INT4_MAX = 2**31 - 1


@dataclass(frozen=True)
class ContextParams:
    """Derived quantities for one query context (one query strand)."""

    query_length: int
    eff_searchsp: int
    length_adjustment: int
    cutoff_score: int          # gapped cutoff (hit saving)
    cutoff_score_max: int
    word_cutoff_score: int     # ungapped stage cutoff (gap trigger capped)
    reduced_nucl_cutoff: int   # 0.9 * word cutoff, approximate-scoring gate
    x_dropoff_ungapped: int    # raw
    is_valid: bool = True


@dataclass(frozen=True)
class SearchParams:
    options: SearchOptions
    kbp_ungap: KarlinBlock
    kbp_gap: KarlinBlock
    round_down: bool
    gap_x_dropoff: int         # raw
    gap_x_dropoff_final: int   # raw
    contexts: tuple[ContextParams, ...]
    cutoff_score_min: int
    word_cutoff_score_min: int

    @property
    def x_dropoff_max(self) -> int:
        return max((c.x_dropoff_ungapped for c in self.contexts if c.is_valid),
                   default=0)


def nucl_score_table_packed(reward: int, penalty: int) -> np.ndarray:
    """256-entry table of summed scores for 4 packed base comparisons
    (BlastInitialWordParametersNew, blast_parameters.c:247-261).

    Index is the XOR of two packed subject/query bytes; each nonzero 2-bit
    group is a mismatch.
    """
    table = np.zeros(256, dtype=np.int32)
    for i in range(256):
        s = 0
        s += penalty if (i & 3) else reward
        s += penalty if ((i >> 2) & 3) else reward
        s += penalty if ((i >> 4) & 3) else reward
        s += penalty if (i >> 6) else reward
        table[i] = s
    return table


def derive_params(
    options: SearchOptions,
    query_lengths: list[int],
    db_length: int,
    db_num_seqs: int,
) -> SearchParams:
    """Compute all derived parameters for a set of query contexts.

    ``query_lengths`` holds one entry per context (i.e. per query strand,
    in NCBI context order: for strand=both, query0+, query0-, query1+, ...).
    """
    opts = options
    reward, penalty = opts.reward, opts.penalty
    kbp_ungap = ungapped_karlin_block(reward, penalty)
    if opts.gapped:
        kbp_gap, round_down = gapped_karlin_block(
            reward, penalty, opts.gap_open, opts.gap_extend, kbp_ungap
        )
    else:
        kbp_gap, round_down = kbp_ungap, False
    alpha, beta = nucl_alpha_beta(
        reward, penalty, opts.gap_open, opts.gap_extend, opts.gapped, kbp_ungap
    )

    db_len = opts.db_length_override or db_length
    db_n = opts.db_num_seqs_override or db_num_seqs

    contexts: list[ContextParams] = []
    for qlen in query_lengths:
        if qlen <= 0:
            contexts.append(ContextParams(0, 0, 0, INT4_MAX, INT4_MAX,
                                          INT4_MAX, INT4_MAX, 0, False))
            continue
        eff = effective_search_space(
            kbp_gap, alpha, beta, qlen, db_len, db_n, opts.searchsp_override
        )
        # Hit saving cutoff (BlastHitSavingParametersUpdate :905-931)
        if opts.cutoff_score > 0:
            cutoff = cutoff_max = opts.cutoff_score
        else:
            cutoff, _e = blast_cutoffs(1, opts.evalue, kbp_gap,
                                       eff.eff_searchsp, dodecay=False)
            cutoff_max = cutoff
        # Word cutoff (BlastInitialWordParametersUpdate :352-420):
        # gapped path uses the ungapped-KA gap trigger, capped by cutoff_max.
        gap_trigger = int(
            (opts.gap_trigger * LN2 + kbp_ungap.logK) / kbp_ungap.Lambda
        )
        if opts.gapped:
            word_cutoff = gap_trigger
        else:
            # ungapped search: cutoff from expect 0.05 with gap decay .5
            cutoff_e = 0.05
            word_cutoff, _ = blast_cutoffs(
                1, cutoff_e, kbp_ungap,
                min(db_len, 2 * qlen) * db_len, dodecay=True,
                gap_decay_rate=0.5,
            )
        word_cutoff = min(word_cutoff, cutoff_max)
        x_drop = int(math.ceil(opts.x_dropoff_ungapped * LN2 / kbp_ungap.Lambda))
        contexts.append(
            ContextParams(
                query_length=qlen,
                eff_searchsp=eff.eff_searchsp,
                length_adjustment=eff.length_adjustment,
                cutoff_score=cutoff,
                cutoff_score_max=cutoff_max,
                word_cutoff_score=word_cutoff,
                reduced_nucl_cutoff=int(0.9 * word_cutoff),
                x_dropoff_ungapped=x_drop if x_drop else word_cutoff,
            )
        )

    # Extension params (BlastExtensionParametersNew :456-464)
    gap_x = int(opts.gap_x_dropoff * LN2 / kbp_gap.Lambda) if opts.gapped else 0
    gap_x_final = (
        max(int(opts.gap_x_dropoff_final * LN2 / kbp_gap.Lambda), gap_x)
        if opts.gapped else 0
    )

    valid = [c for c in contexts if c.is_valid]
    return SearchParams(
        options=opts,
        kbp_ungap=kbp_ungap,
        kbp_gap=kbp_gap,
        round_down=round_down,
        gap_x_dropoff=gap_x,
        gap_x_dropoff_final=gap_x_final,
        contexts=tuple(contexts),
        cutoff_score_min=min((c.cutoff_score for c in valid), default=INT4_MAX),
        word_cutoff_score_min=min((c.word_cutoff_score for c in valid),
                                  default=INT4_MAX),
    )
