"""The subcommands of the port's CLI that do not search.

The port's own copy of ``run_makedb``, ``run_makembindex``,
``run_dustmasker``, ``run_windowmasker``, ``run_aliastool``,
``run_blastdbcheck``, ``run_convert2blastmask`` and ``run_blastdbcmd``
from ``gblastn_tpu/cli/main.py``, unchanged but for the imports.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from gblastn_tpu_torch.io.fasta import parse_fasta
from gblastn_tpu_torch.io.seqdb import SequenceDB


def run_makedb(argv) -> int:
    p = argparse.ArgumentParser(prog="gblastn-tpu makedb")
    p.add_argument("-in", dest="input", required=True,
                   help="input FASTA file")
    p.add_argument("-out", required=True, help="output database directory")
    p.add_argument("-title", default="")
    p.add_argument("-blastdb_version", type=int, default=0,
                   help="4 or 5 = also write an NCBI volume "
                        "(<out>.nin/.nhr/.nsq) next to the native db; "
                        "prefer 4 for NCBI-tool interop (our v5 volumes "
                        "omit the LMDB id sidecar)")
    p.add_argument("-mask_data", default=None,
                   help="comma-separated interval mask files "
                        "(dustmasker/windowmasker/convert2blastmask "
                        "output) stored as db mask columns")
    p.add_argument("-mask_id", default=None,
                   help="comma-separated algorithm ids for -mask_data "
                        "files (default: dust=10, windowmasker=30, "
                        "repeat=40, other=100+)")
    p.add_argument("-mask_desc", default=None,
                   help="comma-separated algorithm descriptions")
    args = p.parse_args(argv)
    db = SequenceDB.from_fasta(args.input, title=args.title or args.input)
    if args.mask_data:
        from gblastn_tpu_torch.io.maskdata import read_interval_masks

        files = args.mask_data.split(",")
        ids = (
            [int(x) for x in args.mask_id.split(",")]
            if args.mask_id else []
        )
        descs = args.mask_desc.split(",") if args.mask_desc else []
        for i, f in enumerate(files):
            algo = ids[i] if i < len(ids) else 100 + i
            desc = descs[i] if i < len(descs) else Path(f).name
            program = {10: "dust", 20: "seg", 30: "windowmasker",
                       40: "repeat"}.get(algo, "other")
            db.add_mask_set(
                algo, program, desc, read_interval_masks(f)
            )
            print(
                f"Mask data {f}: algorithm id {algo} ({program})",
                file=sys.stderr,
            )
    db.save(args.out)
    if args.blastdb_version in (4, 5):
        from gblastn_tpu_torch.io.fasta import parse_fasta
        from gblastn_tpu_torch.io.ncbidb import write_volume

        write_volume(args.out, list(parse_fasta(args.input)),
                     title=args.title or args.input,
                     version=args.blastdb_version)
    elif args.blastdb_version:
        p.error("only -blastdb_version 4 or 5 is supported")
    info = db.info()
    print(
        f"Built database {args.out}: {info.num_seqs} sequences, "
        f"{info.total_length} bases",
        file=sys.stderr,
    )
    return 0


def run_makembindex(argv) -> int:
    """makembindex analog (reference: src/app/blastdb/makembindex.cpp,
    algo/blast/dbindex/): build the on-disk database word index that
    `-use_index true` resolves seeds against (lut/dbindex.py)."""
    p = argparse.ArgumentParser(prog="gblastn-tpu makembindex")
    p.add_argument("-input", "-db", dest="db", required=True,
                   help="database directory (makedb output)")
    p.add_argument("-output", dest="output", default=None,
                   help="index path (default: <db>.tix.npz)")
    p.add_argument("-word_size", type=int, default=28,
                   help="full word size the index serves (default 28, "
                        "traditional megablast)")
    p.add_argument("-lut_word", type=int, default=0,
                   help="indexed width (default: 12, or word_size if "
                        "smaller); searches force their LUT width to "
                        "this so indexed results are bit-identical to "
                        "a scan at the same width")
    args = p.parse_args(argv)
    from gblastn_tpu_torch.lut.dbindex import build_db_index, save_db_index

    db = SequenceDB.load(args.db)
    t0 = time.time()
    index = build_db_index(db, args.word_size, args.lut_word)
    path = save_db_index(index, args.output or args.db)
    print(
        f"Built index {path}: word_size {index.word_size}, lut_word "
        f"{index.lut_word}, stride {index.stride}, "
        f"{len(index.positions)} positions, max chain "
        f"{index.max_chain}, {time.time() - t0:.1f}s",
        file=sys.stderr,
    )
    return 0


def run_dustmasker(argv) -> int:
    """dustmasker app analog (reference: src/app/dustmasker)."""
    p = argparse.ArgumentParser(prog="gblastn-tpu dustmasker")
    p.add_argument("-in", dest="input", required=True)
    p.add_argument("-out", default="-")
    p.add_argument("-level", type=int, default=20)
    p.add_argument("-window", type=int, default=64)
    p.add_argument("-linker", type=int, default=1)
    p.add_argument("-outfmt", default="interval",
                   choices=["interval", "fasta"])
    args = p.parse_args(argv)

    from gblastn_tpu_torch.io.encoding import seq_to_blastna
    from gblastn_tpu_torch.masking.dust import dust_mask

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        for rec in parse_fasta(args.input):
            codes = seq_to_blastna(rec.sequence)
            intervals = dust_mask(
                codes, args.level, args.window, args.linker
            )
            if args.outfmt == "interval":
                title = (rec.seq_id + " " + rec.title).strip()
                out.write(f">{title}\n")
                for a, b in intervals:
                    out.write(f"{a} - {b}\n")
            else:
                # masked-to-lowercase FASTA
                seq = bytearray(
                    rec.sequence if isinstance(rec.sequence, bytes)
                    else rec.sequence.encode()
                )
                for a, b in intervals:
                    seq[a: b + 1] = seq[a: b + 1].lower()
                title = (rec.seq_id + " " + rec.title).strip()
                out.write(f">{title}\n")
                text = seq.decode()
                for i in range(0, len(text), 60):
                    out.write(text[i: i + 60] + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def run_windowmasker(argv) -> int:
    """windowmasker app analog: -mk_counts stage and masking stage
    (reference: src/app/winmasker)."""
    p = argparse.ArgumentParser(prog="gblastn-tpu windowmasker")
    p.add_argument("-mk_counts", action="store_true",
                   help="generate unit counts statistics")
    p.add_argument("-in", dest="input", required=True)
    p.add_argument("-out", required=True)
    p.add_argument("-ustat", default=None,
                   help="statistics file (masking stage)")
    p.add_argument("-unit", type=int, default=0)
    p.add_argument("-t_high", type=int, default=0)
    p.add_argument("-t_low", type=int, default=0)
    p.add_argument("-outfmt", default="interval")
    p.add_argument("-sformat", default="ascii",
                   choices=["ascii", "binary", "oascii", "obinary"],
                   help="counts statistics format for -mk_counts "
                        "(all four NCBI formats load and write)")
    args = p.parse_args(argv)

    from gblastn_tpu_torch.io.encoding import seq_to_blastna
    from gblastn_tpu_torch.masking.winmask import (
        WindowMaskerStats,
        generate_counts,
        window_mask,
    )

    if args.mk_counts:
        seqs = [
            seq_to_blastna(rec.sequence)
            for rec in parse_fasta(args.input)
        ]
        stats = generate_counts(
            seqs, unit_size=args.unit,
            t_high_override=args.t_high, t_low_override=args.t_low,
        )
        save = {
            "binary": stats.save_binary,
            "oascii": stats.save_oascii,
            "obinary": stats.save_obinary,
        }.get(args.sformat, stats.save_ascii)
        save(args.out)
        print(
            f"windowmasker: unit={stats.unit_size} t_low={stats.t_low} "
            f"t_extend={stats.t_extend} t_threshold={stats.t_threshold} "
            f"t_high={stats.t_high} units={len(stats.units)}",
            file=sys.stderr,
        )
        return 0

    if not args.ustat:
        p.error("masking stage requires -ustat")
    stats = WindowMaskerStats.load(args.ustat)
    with open(args.out, "w") as out:
        for rec in parse_fasta(args.input):
            intervals = window_mask(seq_to_blastna(rec.sequence), stats)
            out.write(f">{rec.seq_id} {rec.title}".rstrip() + "\n")
            for a, b in intervals:
                out.write(f"{a} - {b}\n")
    return 0


def run_aliastool(argv) -> int:
    """blastdb_aliastool analog (reference:
    src/app/blastdb/blastdb_aliastool.cpp): present several databases
    as one. Native db dirs get an ``alias.json`` directory; NCBI-style
    prefixes get a ``.nal`` text alias (both load transparently)."""
    p = argparse.ArgumentParser(prog="gblastn-tpu blastdb_aliastool")
    p.add_argument("-dblist", required=True,
                   help="space-separated member database paths")
    p.add_argument("-out", required=True, dest="out",
                   help="alias database name")
    p.add_argument("-title", default="")
    p.add_argument("-dbtype", default="nucl", choices=["nucl"])
    args = p.parse_args(argv)

    members = args.dblist.split()
    native = all(
        (Path(m) / "manifest.json").exists()
        or (Path(m) / "alias.json").exists()
        for m in members
    )
    if native:
        import json

        outdir = Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        (outdir / "alias.json").write_text(json.dumps({
            "title": args.title or args.out,
            "dblist": members,
        }))
        # validate it loads
        db = SequenceDB.load(outdir)
        print(
            f"Created alias {args.out}: {len(members)} members, "
            f"{db.num_seqs} sequences, {db.total_length} bases",
            file=sys.stderr,
        )
    else:
        # NCBI-style .nal text alias (ncbidb.py reads these natively)
        nal = Path(str(args.out) + ".nal")
        nal.write_text(
            f"TITLE {args.title or args.out}\n"
            f"DBLIST {' '.join(members)}\n"
        )
        print(f"Created alias file {nal}", file=sys.stderr)
    return 0


def run_blastdbcheck(argv) -> int:
    """blastdbcheck analog (reference: src/app/blastdb/blastdbcheck.cpp):
    verify database integrity."""
    p = argparse.ArgumentParser(prog="gblastn-tpu blastdbcheck")
    p.add_argument("-db", required=True)
    p.add_argument("-full", action="store_true",
                   help="also decode every sequence")
    args = p.parse_args(argv)

    issues: list[str] = []
    try:
        db = SequenceDB.load(args.db)
    except Exception as e:
        print(f"{args.db}: LOAD FAILED: {e}", file=sys.stderr)
        return 2
    n = db.num_seqs
    if len(db.starts) != n or len(db.lengths) != n or len(db.titles) != n:
        issues.append("metadata array lengths disagree")
    if len(set(db.ids)) != n:
        issues.append("duplicate sequence ids")
    if n and (np.diff(db.starts) <= 0).any():
        issues.append("subject starts not strictly increasing")
    ends = db.starts + db.lengths
    if n and (ends > db.padded_length).any():
        issues.append("subject extends past packed buffer")
    if n and (np.asarray(db.starts) % 4).any():
        issues.append("subject start not byte-aligned")
    if len(db.ambig_pos) != len(db.ambig_code):
        issues.append("ambiguity arrays disagree")
    if len(db.ambig_pos) and (
        (db.ambig_pos < 0) | (db.ambig_pos >= db.padded_length)
    ).any():
        issues.append("ambiguity position out of range")
    for algo, m in db.masks.items():
        iv = m.intervals
        if len(iv) and (
            (iv[:, 0] >= iv[:, 1]).any()
            or (iv[:, 1] > db.padded_length).any()
            or (np.diff(iv[:, 0]) < 0).any()
        ):
            issues.append(f"mask column {algo}: bad intervals")
    if args.full:
        for oid in range(n):
            seq = db.get_sequence_blastna(oid)
            if len(seq) != int(db.lengths[oid]):
                issues.append(f"oid {oid}: decode length mismatch")
            elif (seq > 15).any():
                issues.append(f"oid {oid}: invalid residue code")
    status = "ok" if not issues else "FAILED"
    print(
        f"{args.db}: {n} sequences, {db.total_length} bases, "
        f"{len(db.masks)} mask column(s): {status}"
    )
    for msg in issues:
        print(f"  {msg}", file=sys.stderr)
    return 0 if not issues else 1


def run_convert2blastmask(argv) -> int:
    """convert2blastmask analog: extract lowercase-masked ranges from a
    FASTA file into makedb -mask_data interval files (reference:
    src/app/blastdb/convert2blastmask.cpp)."""
    p = argparse.ArgumentParser(prog="gblastn-tpu convert2blastmask")
    p.add_argument("-in", dest="input", required=True,
                   help="lowercase-masked FASTA")
    p.add_argument("-out", default="-")
    p.add_argument("-masking_algorithm", default="other",
                   help="algorithm name recorded for provenance")
    p.add_argument("-masking_options", default="")
    args = p.parse_args(argv)

    from gblastn_tpu_torch.io.maskdata import (
        lowercase_halfopen,
        write_interval_masks,
    )

    masks = {}
    for rec in parse_fasta(args.input):
        ivs = lowercase_halfopen(rec.sequence)
        if ivs:
            masks[rec.seq_id] = ivs
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        write_interval_masks(out, masks)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def run_blastdbcmd(argv) -> int:
    """blastdbcmd analog: DB info and sequence retrieval (reference:
    src/app/blastdb/blastdbcmd.cpp)."""
    p = argparse.ArgumentParser(prog="gblastn-tpu blastdbcmd")
    p.add_argument("-db", required=True)
    p.add_argument("-info", action="store_true")
    p.add_argument("-entry", default=None,
                   help="comma-separated sequence ids, or 'all'")
    p.add_argument("-entry_batch", default=None,
                   help="file with one sequence id per line")
    p.add_argument("-range", dest="range_", default=None,
                   help="1-based inclusive range a-b")
    p.add_argument("-strand", default="plus", choices=["plus", "minus"])
    p.add_argument("-outfmt", default="%f",
                   help="output format: %%f FASTA (default), or a "
                        "line per sequence with %%a id, %%t title, "
                        "%%l length, %%o oid, %%g gi, %%s sequence")
    p.add_argument("-out", default="-")
    args = p.parse_args(argv)

    from gblastn_tpu_torch.io.encoding import (
        blastna_to_seq,
        reverse_complement_blastna,
    )

    db = SequenceDB.load(args.db)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        if args.info or not (args.entry or args.entry_batch):
            info = db.info()
            out.write(f"Database: {info.title}\n")
            out.write(
                f"\t{info.num_seqs:,} sequences; "
                f"{info.total_length:,} total bases\n\n"
            )
            out.write(f"Longest sequence: {info.max_length:,} bases\n")
            if db.masks:
                out.write("\nAvailable filtering algorithms applied "
                          "to database sequences:\n\n")
                out.write("Algorithm ID  Algorithm name      "
                          "Algorithm options\n")
                for algo, m in sorted(db.masks.items()):
                    out.write(
                        f"{algo:>12}  {m.program:<18}  {m.options}\n"
                    )
            return 0
        ids: list[str] = []
        if args.entry:
            ids.extend(args.entry.split(","))
        if args.entry_batch:
            ids.extend(
                ln.strip()
                for ln in Path(args.entry_batch).read_text().splitlines()
                if ln.strip()
            )
        if args.entry == "all":
            oids = list(range(db.num_seqs))
        else:
            # O(log n) per id via the sorted index (ISAM role)
            oids = []
            missing = []
            for sid in ids:
                oid = db.oid_of_id(sid)
                if oid is None:
                    missing.append(sid)
                else:
                    oids.append(oid)
            if missing:
                print(
                    f"Error: {','.join(missing)}: not found",
                    file=sys.stderr,
                )
                return 1
        from gblastn_tpu_torch.io.seqdb import seq_id_gi

        for oid in oids:
            seq = db.get_sequence_blastna(oid)
            lo, hi = 1, len(seq)
            if args.range_:
                a, b = args.range_.split("-")
                lo, hi = int(a), int(b)
            seq = seq[lo - 1: hi]
            if args.strand == "minus":
                seq = reverse_complement_blastna(seq)
            if args.outfmt == "%f":
                title = (db.ids[oid] + " " + db.titles[oid]).strip()
                out.write(f">{title}\n")
                text = blastna_to_seq(seq)
                for i in range(0, len(text), 80):
                    out.write(text[i: i + 80] + "\n")
            else:
                # custom format line (blastdbcmd.cpp x_ProcessEntry
                # %-specifier substitution)
                gi = seq_id_gi(db.ids[oid])
                line = args.outfmt
                subs = {
                    "%a": db.ids[oid],
                    "%i": db.ids[oid],
                    "%t": db.titles[oid] or "N/A",
                    "%l": str(int(db.lengths[oid])),
                    "%o": str(oid),
                    "%g": str(gi) if gi is not None else "N/A",
                    "%s": blastna_to_seq(seq),
                }
                line = line.replace("%%", "\x00")
                for k, v in subs.items():
                    line = line.replace(k, v)
                out.write(line.replace("\x00", "%") + "\n")
        return 0
    finally:
        if out is not sys.stdout:
            out.close()
