"""The blastn argument table and option building of the port's CLI.

The port's own copy of ``_add_blastn_args``, ``_parse_loc``,
``_build_options`` and ``_parse_outfmt`` from ``gblastn_tpu/cli/main.py``
(the blastn argument surface of NCBI blastn_app.cpp / blast_args.cpp),
unchanged but for the imports.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from gblastn_tpu_torch.params.options import options_for_task


def _add_blastn_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-query", help="query FASTA file", default=None)
    p.add_argument("-query_list", default=None,
                   help="file listing query FASTA paths (G-BLASTN)")
    p.add_argument("-db", default=None,
                   help="database (makedb dir or NCBI .nin/.nal prefix)")
    p.add_argument("-subject", default=None,
                   help="subject FASTA (bl2seq mode, instead of -db)")
    p.add_argument("-lcase_masking", action="store_true",
                   help="mask lowercase query letters")
    p.add_argument("-out", default="-", help="output file (default stdout)")
    p.add_argument("-task", default="megablast",
                   choices=["megablast", "blastn", "dc-megablast",
                            "blastn-short", "vecscreen"])
    p.add_argument("-template_type", default=None,
                   choices=["coding", "optimal", "coding_and_optimal"],
                   help="discontiguous template type (dc-megablast)")
    p.add_argument("-template_length", type=int, default=None,
                   choices=[16, 18, 21],
                   help="discontiguous template length (dc-megablast)")
    p.add_argument("-evalue", type=float, default=10.0)
    p.add_argument("-word_size", type=int, default=0)
    p.add_argument("-window_size", type=int, default=None,
                   help="two-hit window; 0 (default) = one-hit")
    p.add_argument("-off_diagonal_range", type=int, default=0,
                   help="number of off-diagonals to search for the "
                        "2nd hit (two-hit mode)")
    p.add_argument("-ungapped", action="store_true",
                   help="ungapped search (sum-statistics e-values)")
    p.add_argument("-use_index", default=None,
                   help="true = resolve seeds against a prebuilt "
                        "database word index (makembindex) instead of "
                        "scanning the database")
    p.add_argument("-index_name", default=None,
                   help="database index path (default: <db>.tix.npz)")
    p.add_argument("-old_style_index", default=None,
                   help="accepted for compatibility (this framework "
                        "has one index format)")
    p.add_argument("-version", action="version",
                   version="blastn: 2.2.28+ (gblastn-tpu 0.1.0)")
    p.add_argument("-reward", type=int, default=0)
    p.add_argument("-penalty", type=int, default=0)
    p.add_argument("-gapopen", type=int, default=None)
    p.add_argument("-gapextend", type=int, default=None)
    p.add_argument("-max_target_seqs", type=int, default=None)
    p.add_argument("-num_alignments", type=int, default=None)
    p.add_argument("-outfmt", default="6")
    p.add_argument("-line_length", type=int, default=60,
                   help="alignment line length (outfmt 0-4)")
    p.add_argument("-num_descriptions", type=int, default=500,
                   help="one-line summary count (outfmt 0-4)")
    p.add_argument("-html", action="store_true",
                   help="wrap report output in HTML (outfmt 0-4)")
    p.add_argument("-parse_deflines", action="store_true",
                   help="parse query/subject deflines (accepted for "
                        "compatibility; ids are always the first "
                        "defline token here)")
    p.add_argument("-show_gis", action="store_true",
                   help="show NCBI GIs in deflines (accepted for "
                        "compatibility; local dbs carry no GIs)")
    p.add_argument("-query_loc", default=None,
                   help="location on the query sequence "
                        "(format: start-stop, 1-based inclusive)")
    p.add_argument("-subject_loc", default=None,
                   help="location on the subject sequence, bl2seq mode "
                        "only (format: start-stop, 1-based inclusive)")
    p.add_argument("-strand", default="both",
                   choices=["both", "plus", "minus"])
    p.add_argument("-perc_identity", type=float, default=0.0)
    p.add_argument("-best_hit_overhang", type=float, default=0.0)
    p.add_argument("-best_hit_score_edge", type=float, default=0.0)
    p.add_argument("-culling_limit", type=int, default=0)
    p.add_argument("-dbsize", type=int, default=0,
                   help="effective database length override")
    p.add_argument("-searchsp", type=int, default=0,
                   help="effective search space override")
    p.add_argument("-dust", default="yes")
    p.add_argument("-soft_masking", default="true",
                   help="true (default): query filters apply to "
                        "seeding only; false: masked bases become N "
                        "for the whole search")
    p.add_argument("-window_masker_db", default=None)
    p.add_argument("-window_masker_taxid", type=int, default=None,
                   help="resolve the windowmasker statistics from "
                        "$WINDOW_MASKER_PATH/<taxid>/wmasker.obinary "
                        "(or .oascii), like the reference")
    p.add_argument("-filtering_db", default=None,
                   help="repeats database for query masking")
    p.add_argument("-gilist", default=None,
                   help="restrict the search to database sequences "
                        "whose deflines carry a GI in this list "
                        "(NCBI text or binary GI list)")
    p.add_argument("-negative_gilist", default=None,
                   help="exclude database sequences whose deflines "
                        "carry a GI in this list")
    p.add_argument("-seqidlist", default=None,
                   help="restrict the search to database sequences "
                        "whose ids are listed in this file")
    p.add_argument("-negative_seqidlist", default=None,
                   help="exclude database sequences whose ids are "
                        "listed in this file")
    p.add_argument("-db_soft_mask", type=int, default=None,
                   help="database masking algorithm id: masked subject "
                        "ranges are excluded from seeding")
    p.add_argument("-db_hard_mask", type=int, default=None,
                   help="database masking algorithm id: masked subject "
                        "ranges excluded from seeding and rendered N")
    p.add_argument("-xdrop_ungap", type=float, default=None,
                   help="X-dropoff (bits) for ungapped extensions")
    p.add_argument("-xdrop_gap", type=float, default=None,
                   help="X-dropoff (bits) for preliminary gapped "
                        "extensions")
    p.add_argument("-xdrop_gap_final", type=float, default=None,
                   help="X-dropoff (bits) for final gapped alignment")
    p.add_argument("-gap_trigger", type=float, default=None,
                   help="score (bits) to trigger gapped extension "
                        "(ungapped cutoff ceiling)")
    p.add_argument("-max_hsps_per_subject", type=int, default=0,
                   help="max HSPs kept per subject sequence (0 = all)")
    p.add_argument("-no_greedy", action="store_true",
                   help="megablast: use non-greedy dynamic programming "
                        "extension")
    p.add_argument("-min_raw_gapped_score", type=int, default=0,
                   help="minimum raw gapped score for saved HSPs")
    p.add_argument("-num_threads", type=int, default=1)
    # G-BLASTN compatibility flags, mapped to TPU equivalents
    p.add_argument("-use_gpu", default=None, help="alias of -use_tpu")
    p.add_argument("-use_tpu", default="true")
    p.add_argument("-gpu_id", type=int, default=0, help="alias of -tpu_id")
    p.add_argument("-tpu_id", type=int, default=0)
    p.add_argument("-mode", type=int, default=1, choices=[0, 1, 2])
    # pipeline stage thread counts (G-BLASTN flags; reference
    # spellings from cmdline_flags.cpp:228-237 accepted as aliases)
    p.add_argument("-prepare_thread", "-pre_t_num", type=int, default=1)
    p.add_argument("-prelim_thread", "-prelim_t_num", type=int,
                   default=1)
    p.add_argument("-trace_thread", "-trace_t_num", type=int, default=2)
    p.add_argument("-print_thread", "-print_t_num", type=int, default=1)
    p.add_argument("-logfile", default=None,
                   help="write the stage timing report here")
    p.add_argument("-export_search_strategy", default=None,
                   help="save the search request (query/db/options)")
    p.add_argument("-import_search_strategy", default=None,
                   help="recover a saved search request")


def _parse_loc(flag: str, text: str) -> tuple[int, int]:
    """Parse a 1-based 'start-stop' range flag (-query_loc,
    -subject_loc); SystemExit with an options error on bad input."""
    try:
        s, _, e = text.partition("-")
        start, stop = int(s), int(e)
        if start < 1 or stop < start:
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"BLAST options error: {flag} must be start-stop "
            "(1-based, start <= stop)"
        )
    return start, stop


def _build_options(args):
    overrides = {}
    if args.word_size:
        overrides["word_size"] = args.word_size
    if args.reward:
        overrides["reward"] = args.reward
    if args.penalty:
        overrides["penalty"] = args.penalty
    if args.gapopen is not None:
        overrides["gap_open"] = args.gapopen
    if args.gapextend is not None:
        overrides["gap_extend"] = args.gapextend
    mts = args.max_target_seqs or args.num_alignments
    if mts:
        overrides["max_target_seqs"] = mts
        overrides["hitlist_size"] = mts
    overrides["evalue"] = args.evalue
    overrides["strand"] = args.strand
    overrides["percent_identity"] = args.perc_identity
    if args.best_hit_overhang:
        overrides["best_hit_overhang"] = args.best_hit_overhang
    if args.best_hit_score_edge:
        overrides["best_hit_score_edge"] = args.best_hit_score_edge
    if args.culling_limit:
        overrides["culling_limit"] = args.culling_limit
    if args.num_threads and args.num_threads > 1:
        overrides["num_threads"] = args.num_threads
    if args.dbsize:
        overrides["db_length_override"] = args.dbsize
    if args.searchsp:
        overrides["searchsp_override"] = args.searchsp
    parts = str(args.dust).split()
    if len(parts) == 3 and all(x.lstrip("-").isdigit() for x in parts):
        overrides["dust"] = True
        overrides["dust_level"] = int(parts[0])
        overrides["dust_window"] = int(parts[1])
        overrides["dust_linker"] = int(parts[2])
    else:
        overrides["dust"] = args.dust in ("yes", "true", "T")
    if args.window_masker_db:
        overrides["window_masker_db"] = args.window_masker_db
    elif args.window_masker_taxid is not None:
        # WindowMaskerTaxidToDb (winmask_filter.cpp:428): try the
        # binary unit counts first, then ascii, under
        # $WINDOW_MASKER_PATH/<taxid>/
        import os

        base = Path(os.environ.get("WINDOW_MASKER_PATH", "."))
        tdir = base / str(args.window_masker_taxid)
        for name in ("wmasker.obinary", "wmasker.oascii"):
            if (tdir / name).exists():
                overrides["window_masker_db"] = str(tdir / name)
                break
        else:
            raise SystemExit(
                "BLAST options error: no windowmasker statistics for "
                f"taxid {args.window_masker_taxid} under {base}"
            )
    if str(args.soft_masking).lower() in ("false", "f", "no", "0"):
        overrides["mask_at_hash"] = False
    if args.filtering_db:
        overrides["filtering_db"] = args.filtering_db
    if args.window_size is not None:
        overrides["window_size"] = args.window_size
    if args.off_diagonal_range:
        overrides["off_diagonal_range"] = args.off_diagonal_range
    if args.query_loc:
        start, stop = _parse_loc("-query_loc", args.query_loc)
        overrides["query_loc"] = (start - 1, stop)
    if args.db_soft_mask is not None:
        overrides["db_soft_mask"] = args.db_soft_mask
    if args.db_hard_mask is not None:
        overrides["db_hard_mask"] = args.db_hard_mask
    if args.ungapped:
        overrides["gapped"] = False
    if args.lcase_masking:
        overrides["lcase_masking"] = True
    if str(args.use_index).lower() in ("true", "t", "yes", "1"):
        overrides["use_index"] = True
        if args.index_name:
            overrides["index_name"] = args.index_name
    if args.xdrop_ungap is not None:
        overrides["x_dropoff_ungapped"] = args.xdrop_ungap
    if args.xdrop_gap is not None:
        overrides["gap_x_dropoff"] = args.xdrop_gap
    if args.xdrop_gap_final is not None:
        overrides["gap_x_dropoff_final"] = args.xdrop_gap_final
    if args.gap_trigger is not None:
        overrides["gap_trigger"] = args.gap_trigger
    if args.max_hsps_per_subject:
        overrides["max_hsps_per_subject"] = args.max_hsps_per_subject
    if args.min_raw_gapped_score:
        overrides["cutoff_score"] = args.min_raw_gapped_score
    if args.no_greedy:
        from gblastn_tpu_torch.params.options import ExtensionMethod

        overrides["extension_method"] = ExtensionMethod.DYN_PROG
    if args.template_type is not None:
        overrides["template_type"] = args.template_type
    if args.template_length is not None:
        overrides["template_length"] = args.template_length
    if (args.task != "dc-megablast"
            and (args.template_type is not None
                 or args.template_length is not None)):
        raise SystemExit(
            "BLAST options error: -template_type/-template_length "
            "require -task dc-megablast"
        )
    return options_for_task(args.task, **overrides)


def _parse_outfmt(outfmt: str):
    parts = outfmt.split()
    kind = int(parts[0])
    fields = parts[1:] or None
    if kind not in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 17):
        raise SystemExit(
            f"-outfmt {kind} not supported "
            "(0 pairwise, 1-4 query-anchored, 5 XML, 6/7 tabular, "
            "8/9 ASN.1, 10 CSV, 11 archive, 17 SAM)"
        )
    return kind, fields
