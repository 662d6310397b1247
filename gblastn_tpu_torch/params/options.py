"""Search options with per-task defaults.

Mirrors the option surface of the reference CLI / options handles
(reference: NCBI c++/src/algo/blast/api/blast_nucl_options.cpp:58-240
and NCBI c++/include/algo/blast/core/blast_options.h:58-147) as a
single flat frozen dataclass. Tasks:

* ``megablast``: word 28, reward/penalty 1/-2, linear (greedy) gap costs,
  greedy extension, X-drops 20/25/100 bits.
* ``blastn``:    word 11, reward/penalty 2/-3, gap costs 5/2, dynamic
  programming extension, X-drops 20/30/100 bits.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum


class Task(str, Enum):
    MEGABLAST = "megablast"
    BLASTN = "blastn"
    DC_MEGABLAST = "dc-megablast"
    BLASTN_SHORT = "blastn-short"
    VECSCREEN = "vecscreen"


class ExtensionMethod(str, Enum):
    GREEDY = "greedy"        # eGreedyScoreOnly / eGreedyTbck
    DYN_PROG = "dyn_prog"    # eDynProgScoreOnly / eDynProgTbck


@dataclass(frozen=True)
class SearchOptions:
    task: Task = Task.MEGABLAST
    word_size: int = 28
    lut_word_size: int = 0          # 0 = choose automatically (lut builder)
    reward: int = 1
    penalty: int = -2
    gap_open: int = 0
    gap_extend: int = 0
    gapped: bool = True
    extension_method: ExtensionMethod = ExtensionMethod.GREEDY

    # X-dropoffs, in bits (converted to raw scores by derived params).
    x_dropoff_ungapped: float = 20.0    # BLAST_UNGAPPED_X_DROPOFF_NUCL
    gap_x_dropoff: float = 25.0         # BLAST_GAP_X_DROPOFF_GREEDY
    gap_x_dropoff_final: float = 100.0  # BLAST_GAP_X_DROPOFF_FINAL_NUCL
    gap_trigger: float = 27.0           # BLAST_GAP_TRIGGER_NUCL, bits

    # Hit saving
    evalue: float = 10.0
    hitlist_size: int = 500
    max_hsps_per_subject: int = 0       # 0 = unlimited
    percent_identity: float = 0.0
    min_diag_separation: int = 6        # 50 for blastn
    cutoff_score: int = 0               # 0 = derive from evalue
    low_score_perc: float = 0.0    # off by default (calloc'd options)
    best_hit_overhang: float = 0.0      # 0 = best-hit filter off
    best_hit_score_edge: float = 0.0
    culling_limit: int = 0              # 0 = culling filter off
    num_threads: int = 1                # host-stage worker threads
    max_target_seqs: int | None = None  # alias of hitlist_size at CLI level

    # Query handling
    strand: str = "both"                # both|plus|minus
    dust: bool = True
    dust_level: int = 20                # symdust parameters (-dust "L W T")
    dust_window: int = 64
    dust_linker: int = 1
    window_masker_db: str | None = None
    filtering_db: str | None = None     # repeats database (-filtering_db)
    lcase_masking: bool = False         # lowercase query letters mask
    # -soft_masking: True (default) applies query filters at seeding
    # only (mask-at-hash); False rewrites masked query bases to N for
    # the whole search (BlastSetUp_MaskQuery), with the unmasked copy
    # kept for identity counting and report display
    mask_at_hash: bool = True
    window_size: int = 0                # two-hit window; 0 = one-hit
    off_diagonal_range: int = 0         # two-hit off-diagonal probe
    # -query_loc "start-stop": restrict the search to a query range
    # (0-based half-open here; every query in the batch)
    query_loc: tuple[int, int] | None = None

    # Subject-side masking: filtering algorithm id stored in the
    # database's mask columns (-db_soft_mask / -db_hard_mask)
    db_soft_mask: int | None = None
    db_hard_mask: int | None = None

    # Discontiguous megablast (-task dc-megablast): template window
    # length and type (s_DiscWordOptionsValidate, blast_options.c:1191)
    template_length: int = 0            # 0 = contiguous; 16, 18 or 21
    template_type: str = "coding"       # coding|optimal|coding_and_optimal

    # Indexed megablast (-use_index/-index_name): resolve seeds against
    # a prebuilt database word index (makembindex) instead of scanning
    # the database (lut/dbindex.py)
    use_index: bool = False
    index_name: str | None = None       # default: <db path>.tix.npz

    # Effective length overrides
    db_length_override: int = 0
    db_num_seqs_override: int = 0
    searchsp_override: int = 0

    def replace(self, **kw) -> "SearchOptions":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.word_size < 4:
            raise ValueError("word_size must be >= 4")
        if self.reward <= 0 or self.penalty >= 0:
            raise ValueError("reward must be > 0 and penalty < 0")
        if self.strand not in ("both", "plus", "minus"):
            raise ValueError(f"bad strand {self.strand}")
        if (self.gapped
                and self.gap_open == 0 and self.gap_extend == 0
                and self.extension_method is not ExtensionMethod.GREEDY):
            # BlastExtensionOptionsValidate (blast_options.c:1604)
            raise ValueError(
                "Greedy extension must be used if gap existence and "
                "extension options are zero"
            )
        if self.template_length:
            # s_DiscWordOptionsValidate (blast_options.c:1191)
            if self.template_length not in (16, 18, 21):
                raise ValueError("template_length must be 16, 18 or 21")
            if self.word_size not in (11, 12):
                raise ValueError(
                    "discontiguous template requires word_size 11 or 12"
                )
            if self.template_type not in (
                "coding", "optimal", "coding_and_optimal"
            ):
                raise ValueError(
                    f"bad template_type {self.template_type!r}"
                )


def megablast_options(**overrides) -> SearchOptions:
    """SetTraditionalMegablastDefaults (blast_nucl_options.cpp:85-105)."""
    return SearchOptions(
        task=Task.MEGABLAST,
        word_size=28,
        reward=1,
        penalty=-2,
        gap_open=0,
        gap_extend=0,
        extension_method=ExtensionMethod.GREEDY,
        gap_x_dropoff=25.0,
        min_diag_separation=6,
    ).replace(**overrides)


def blastn_options(**overrides) -> SearchOptions:
    """SetTraditionalBlastnDefaults (blast_nucl_options.cpp:63-83)."""
    return SearchOptions(
        task=Task.BLASTN,
        word_size=11,
        reward=2,
        penalty=-3,
        gap_open=5,
        gap_extend=2,
        extension_method=ExtensionMethod.DYN_PROG,
        gap_x_dropoff=30.0,
        min_diag_separation=50,
    ).replace(**overrides)


def dc_megablast_options(**overrides) -> SearchOptions:
    """CDiscNucleotideOptionsHandle defaults (disc_nucl_options.cpp:25):
    word 11, template 18 coding, two-hit window 40
    (BLAST_WINDOW_SIZE_DISC), blastn scoring 2/-3 gaps 5/2, DP
    extension. Hit saving keeps the megablast defaults (the disc handle
    does not override SetMBHitSavingOptionsDefaults), so
    min_diag_separation stays 6."""
    return SearchOptions(
        task=Task.DC_MEGABLAST,
        word_size=11,
        template_length=18,
        template_type="coding",
        reward=2,
        penalty=-3,
        gap_open=5,
        gap_extend=2,
        extension_method=ExtensionMethod.DYN_PROG,
        gap_x_dropoff=30.0,
        window_size=40,
        min_diag_separation=6,
    ).replace(**overrides)


def blastn_short_options(**overrides) -> SearchOptions:
    """blastn-short (blast_options_handle.cpp:305): blastn with word 7,
    reward 1 / penalty -3, e-value 50, query filtering off -- tuned for
    queries under 50 bases."""
    return blastn_options(
        word_size=7, reward=1, penalty=-3, evalue=50.0, dust=False,
    ).replace(task=Task.BLASTN_SHORT, **overrides)


def vecscreen_options(**overrides) -> SearchOptions:
    """vecscreen (blast_options_handle.cpp:313, VSBlastOptionNew):
    blastn with gap costs 3/3, reward 1 / penalty -5, e-value 700, and
    a fixed 1.75e12 effective search space."""
    return blastn_options(
        reward=1, penalty=-5, gap_open=3, gap_extend=3, evalue=700.0,
        searchsp_override=int(1.75e12),
    ).replace(task=Task.VECSCREEN, **overrides)


def options_for_task(task: str | Task, **overrides) -> SearchOptions:
    task = Task(task)
    if task is Task.MEGABLAST:
        return megablast_options(**overrides)
    if task is Task.DC_MEGABLAST:
        return dc_megablast_options(**overrides)
    if task is Task.BLASTN_SHORT:
        return blastn_short_options(**overrides)
    if task is Task.VECSCREEN:
        return vecscreen_options(**overrides)
    return blastn_options(**overrides)
