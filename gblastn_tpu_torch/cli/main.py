"""blastn-compatible command-line interface of the PyTorch port.

``python -m gblastn_tpu_torch blastn ...`` takes the same arguments as
``python -m gblastn_tpu blastn`` (the argument table and option building
are the port's copy, cli/args.py) plus ``-device cuda|cpu`` (default
cuda; asking for cuda without a card is an error), and searches through
gblastn_tpu_torch.engine.search: the sequential ``-mode 1`` and the
pipelined ``-mode 0/2`` (engine.pipeline). The subcommands that do not
search (makedb, blastdbcmd, dustmasker, ...) are copies too
(cli/dbtools.py), and so is blast_formatter, which re-renders an
``-outfmt 11`` archive on the host.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from gblastn_tpu_torch.cli.args import (
    _add_blastn_args,
    _build_options,
    _parse_loc,
    _parse_outfmt,
)
from gblastn_tpu_torch.cli.dbtools import (
    run_aliastool,
    run_blastdbcheck,
    run_blastdbcmd,
    run_convert2blastmask,
    run_dustmasker,
    run_makedb,
    run_makembindex,
    run_windowmasker,
)
from gblastn_tpu_torch.io.fasta import (
    BATCH_SIZE_BLASTN,
    BATCH_SIZE_MEGABLAST,
    FastaRecord,
    batch_records,
    parse_fasta,
)
from gblastn_tpu_torch.io.seqdb import SequenceDB


def run_blastn(argv) -> int:
    p = argparse.ArgumentParser(prog="gblastn-tpu-torch blastn",
                                add_help=True)
    _add_blastn_args(p)
    p.add_argument("-device", default="cuda",
                   help="cuda (default; an error without a card) or cpu "
                        "(the plain PyTorch path)")
    args = p.parse_args(argv)
    from gblastn_tpu_torch.device import resolve_device
    from gblastn_tpu_torch.engine.search import search

    device = resolve_device(args.device)

    if args.import_search_strategy:
        # RecoverSearchStrategy (blastn_app.cpp:423, search_strategy.cpp)
        text = Path(args.import_search_strategy).read_text()
        if text.lstrip().startswith("{"):
            # legacy JSON strategy files
            import json

            saved_args = json.loads(text).get("args", {})
        else:
            from gblastn_tpu_torch.objects.blast4 import strategy_to_args

            saved_args = strategy_to_args(text)
        for k, v in saved_args.items():
            if getattr(args, k, None) in (None, 0, 0.0, "both", "megablast",
                                          "6", "yes", 10.0, "true", 1,
                                          False):
                setattr(args, k, v)

    if not args.query and not args.query_list:
        p.error("one of -query / -query_list is required")

    options = _build_options(args)
    try:
        options.validate()
        if options.gapped:
            # fail fast on unsupported gap-cost/scoring combos, with
            # the reference's own message (BLAST_PrintAllowedValues)
            from gblastn_tpu_torch.stats.tables import gapped_karlin_block

            gapped_karlin_block(
                options.reward, options.penalty,
                options.gap_open, options.gap_extend,
            )
    except ValueError as e:
        print(f"BLAST options error: {e}", file=sys.stderr)
        return 1

    if args.export_search_strategy:
        # SaveSearchStrategy (blastn_app.cpp:593): a Blast4-request
        # ASN.1 text with the queries embedded as a Bioseq-set
        from gblastn_tpu_torch.io.encoding import IUPACNA_TO_BLASTNA
        from gblastn_tpu_torch.objects.asn1 import to_text
        from gblastn_tpu_torch.objects.blast4 import (
            bioseq,
            bioseq_set,
            blast4_request,
            queue_search_request,
        )

        seqs = []
        strat_files = []
        if args.query_list:
            strat_files = [
                ln.strip()
                for ln in Path(args.query_list).read_text().splitlines()
                if ln.strip()
            ]
        elif args.query:
            strat_files = [args.query]
        for qfile in strat_files:
            for rec in parse_fasta(qfile):
                seqs.append(bioseq(
                    rec.seq_id, rec.title,
                    IUPACNA_TO_BLASTNA[
                        np.frombuffer(rec.sequence, dtype=np.uint8)
                    ],
                ))
        request = blast4_request(
            "blastn: 2.2.28+ (gblastn-tpu)",
            queue_search_request(
                program="blastn",
                service=(
                    "megablast" if args.task == "megablast" else "plain"
                ),
                queries=bioseq_set(seqs),
                subject_db=args.db or args.subject or "",
                paramset=args.task,
                options=options,
            ),
        )
        Path(args.export_search_strategy).write_text(
            to_text("Blast4-request", request)
        )
    subj_shift = None     # per-oid coordinate shift under -subject_loc
    display_db = None     # full-length db for rendering (slen, bases)
    if args.subject:
        if args.db:
            raise SystemExit("use either -db or -subject, not both")
        if args.subject_loc:
            # -subject_loc (bl2seq only): search the sliced subject and
            # remap final coordinates to the full sequence
            # (s_RemapToSubjectLoc, blast_seqalign.cpp:1276)
            start, stop = _parse_loc("-subject_loc", args.subject_loc)
            recs = list(parse_fasta(args.subject))
            display_db = SequenceDB.from_records(
                recs, title=args.subject
            )
            subj_shift = []
            sliced = []
            for rec in recs:
                a = min(start - 1, len(rec.sequence))
                b = min(stop, len(rec.sequence))
                if a >= b:
                    raise SystemExit(
                        "BLAST options error: -subject_loc "
                        f"{args.subject_loc} is outside subject "
                        f"'{rec.seq_id}' (length {len(rec.sequence)})"
                    )
                subj_shift.append(a)
                sliced.append(
                    FastaRecord(rec.seq_id, rec.title,
                                rec.sequence[a:b])
                )
            db = SequenceDB.from_records(sliced, title=args.subject)
        else:
            db = SequenceDB.from_fasta(args.subject, title=args.subject)
    elif args.db:
        if args.subject_loc:
            raise SystemExit(
                "BLAST options error: -subject_loc requires -subject"
            )
        db = SequenceDB.load(args.db)
    else:
        raise SystemExit("one of -db or -subject is required")
    id_restrictions = [
        f for f in ("gilist", "negative_gilist", "seqidlist",
                    "negative_seqidlist")
        if getattr(args, f)
    ]
    if len(id_restrictions) > 1:
        raise SystemExit(
            "BLAST options error: use only one of -gilist, "
            "-negative_gilist, -seqidlist, -negative_seqidlist"
        )
    if id_restrictions and args.subject:
        raise SystemExit(
            f"BLAST options error: -{id_restrictions[0]} requires "
            "-db (incompatible with -subject)"
        )
    if args.gilist or args.negative_gilist:
        from gblastn_tpu_torch.io.seqdb import read_gi_list, seq_id_gi

        try:
            gis = read_gi_list(args.gilist or args.negative_gilist)
        except ValueError as e:
            raise SystemExit(f"BLAST options error: {e}")
        negative = args.negative_gilist is not None
        keep = [
            i for i, sid in enumerate(db.ids)
            if ((g := seq_id_gi(sid)) is not None and g in gis)
            != negative
        ]
        if not keep:
            raise SystemExit(
                "gilist restriction removes every database sequence"
            )
        db = db.subset_oids(keep)
    if args.seqidlist or args.negative_seqidlist:
        listed = {
            ln.strip()
            for ln in Path(
                args.seqidlist or args.negative_seqidlist
            ).read_text().splitlines()
            if ln.strip()
        }
        negative = args.negative_seqidlist is not None
        keep = [
            i for i, sid in enumerate(db.ids)
            if (sid in listed) != negative
        ]
        missing = listed - set(db.ids)
        if missing:
            print(
                "gblastn_tpu: warning: seqidlist ids not in the "
                f"database: {', '.join(sorted(missing)[:5])}",
                file=sys.stderr,
            )
        if not keep:
            raise SystemExit(
                "seqidlist restriction removes every database sequence"
            )
        db = db.subset_oids(keep)
    kind, fields = _parse_outfmt(args.outfmt)

    query_files = []
    if args.query_list:
        for line in Path(args.query_list).read_text().splitlines():
            line = line.strip()
            if line:
                query_files.append(line)
    else:
        query_files.append(args.query)

    if kind == 9:   # binary ASN.1 writes bytes
        out = (
            sys.stdout.buffer if args.out == "-"
            else open(args.out, "wb")
        )
    else:
        out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        from gblastn_tpu_torch.format.render import ResultRenderer

        html = args.html and kind in (0, 1, 2, 3, 4)
        if html:
            out.write("<HTML>\n<HEAD><TITLE>BLAST Search Results"
                      "</TITLE></HEAD>\n<BODY>\n<PRE>\n")
        renderer = ResultRenderer(
            kind, fields, out, display_db or db, options,
            dbname=args.db or args.subject or "", task=args.task,
            line_length=args.line_length,
            num_descriptions=args.num_descriptions,
        )

        batch_size = (
            BATCH_SIZE_MEGABLAST if args.task == "megablast"
            else BATCH_SIZE_BLASTN
        )
        t0 = time.time()

        def emit(results):
            if subj_shift is not None:
                for q in results.queries:
                    for lst in q.hsplists:
                        off = subj_shift[lst.oid]
                        if off:
                            for h in lst.hsps:
                                h.s_off += off
                                h.s_end += off
            renderer.emit(results)

        def all_batches():
            for qfile in query_files:
                yield from batch_records(parse_fasta(qfile), batch_size)

        # cooperative cancellation: first Ctrl-C requests a clean stop
        # at the next stage boundary (partial output stays valid), a
        # second Ctrl-C aborts immediately (TInterruptFnPtr contract)
        import signal
        import threading

        from gblastn_tpu_torch.utils.interrupt import SearchInterrupted

        stop_req = threading.Event()

        def _on_sigint(signum, frame):
            if stop_req.is_set():
                raise KeyboardInterrupt
            stop_req.set()
            print(
                "gblastn_tpu: interrupt requested -- stopping at the "
                "next stage boundary (Ctrl-C again to abort now)",
                file=sys.stderr,
            )

        try:
            prev_handler = signal.signal(signal.SIGINT, _on_sigint)
        except ValueError:       # not the main thread (e.g. tests)
            prev_handler = None
        interrupted = False
        try:
            if args.mode == 1:
                # Method1: sequential per-batch loop (blastn_app.cpp:500)
                for batch in all_batches():
                    emit(search(batch, db, options, device=device,
                                interrupt_fn=stop_req.is_set))
            else:
                # Method2/3: pipelined stages (blastn_app.cpp:725/:991)
                from gblastn_tpu_torch.engine.pipeline import (
                    run_pipelined_search,
                )

                run_pipelined_search(
                    all_batches(), db, options, emit, device=device,
                    interrupt_fn=stop_req.is_set,
                )
        except SearchInterrupted:
            interrupted = True
            print(
                "gblastn_tpu: search interrupted after "
                f"{renderer.num_queries} queries; output above is "
                "complete for those queries",
                file=sys.stderr,
            )
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGINT, prev_handler)
        renderer.finalize()
        if html:
            out.write("</PRE>\n</BODY>\n</HTML>\n")
        print(
            f"# {renderer.num_queries} queries in "
            f"{time.time() - t0:.2f}s",
            file=sys.stderr,
        )
        if args.logfile:
            from gblastn_tpu_torch.utils.profiling import slog

            with open(args.logfile, "w") as lf:
                lf.write(slog.report() + "\n")
        if interrupted:
            return 130
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def run_blast_formatter(argv) -> int:
    """blast_formatter: re-render a -outfmt 11 archive (reference:
    src/app/blast/blast_formatter.cpp) as tabular 6/7/10."""
    p = argparse.ArgumentParser(prog="gblastn-tpu-torch blast_formatter")
    p.add_argument("-archive", required=True,
                   help="Blast4-archive file (-outfmt 11 output)")
    p.add_argument("-outfmt", default="6")
    p.add_argument("-line_length", type=int, default=60,
                   help="alignment line length (outfmt 0-4)")
    p.add_argument("-num_descriptions", type=int, default=500,
                   help="one-line summary count (outfmt 0-4)")
    p.add_argument("-out", default="-")
    args = p.parse_args(argv)

    from gblastn_tpu_torch.format.formatter import format_archive

    text = open(args.archive).read()
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        return format_archive(
            text, out, args.outfmt,
            line_length=args.line_length,
            num_descriptions=args.num_descriptions,
        )
    finally:
        if out is not sys.stdout:
            out.close()


_COMMANDS = {
    "blastn": run_blastn,
    "makedb": run_makedb,
    "makeblastdb": run_makedb,
    "windowmasker": run_windowmasker,
    "blastdbcmd": run_blastdbcmd,
    "dustmasker": run_dustmasker,
    "convert2blastmask": run_convert2blastmask,
    "blastdb_aliastool": run_aliastool,
    "blastdbcheck": run_blastdbcheck,
    "makembindex": run_makembindex,
    "blast_formatter": run_blast_formatter,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = _COMMANDS.get(argv[0])
    if cmd is not None:
        return cmd(argv[1:])
    # default: treat as blastn args directly
    return run_blastn(argv)


if __name__ == "__main__":
    sys.exit(main())
