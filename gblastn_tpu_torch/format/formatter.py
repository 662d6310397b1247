"""blast_formatter: re-render a Blast4-archive (-outfmt 11) report.

Counterpart of the reference's blast_formatter app (reference:
NCBI c++/src/app/blast/blast_formatter.cpp): read a saved
archive and format its alignments with any tabular field set, without
re-running the search. The archive embeds the queries and the
Seq-align-set (coordinates, edit structure, score/e-value/bit-score/
identities), which covers every non-sequence tabular field; the
sequence-dependent fields (btop/qseq/sseq, stitle) additionally need
the archived database, which is opened from the path recorded in the
request when present (exactly how the reference resolves subject data,
blast_formatter.cpp CBlastFormat over a CLocalDbAdapter).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gblastn_tpu_torch.hits import HSP, OP_DEL, OP_INS, OP_SUB
from gblastn_tpu_torch.objects.asn1 import Named, named_get, parse_text, real_value


@dataclass
class ArchiveQuery:
    qid: str
    length: int
    ncbi4na: bytes | None = None


@dataclass
class ArchiveAlignment:
    qid: str
    sid: str
    starts: list[int]
    lens: list[int]
    minus: bool
    score: int = 0
    evalue: float = 0.0
    bit_score: float = 0.0
    num_ident: int = 0


@dataclass
class Archive:
    program: str = "blastn"
    service: str = "megablast"
    dbname: str = ""
    queries: list[ArchiveQuery] = field(default_factory=list)
    alignments: list[ArchiveAlignment] = field(default_factory=list)


def _name(v):
    """Seq-id { local str "x" } / { local id 7 } -> display string."""
    while isinstance(v, Named):
        v = v.value
    if isinstance(v, list):
        v = named_get(v, "local")
        return _name(v)
    return str(v)


def read_archive(text: str) -> Archive:
    tname, root = parse_text(text)
    if tname != "Blast4-archive":
        raise ValueError(f"not a Blast4-archive (got {tname})")
    arch = Archive()

    request = named_get(root, "request", [])
    body = named_get(request, "body")
    if isinstance(body, Named):           # queue-search { ... }
        qs = body.value
        arch.program = str(named_get(qs, "program", "blastn"))
        arch.service = str(named_get(qs, "service", "megablast"))
        subj = named_get(qs, "subject")
        if isinstance(subj, Named) and subj.name == "database":
            arch.dbname = str(subj.value)
        queries = named_get(qs, "queries")
        if isinstance(queries, Named):    # bioseq-set { seq-set {...} }
            for seq in named_get(queries.value, "seq-set", []):
                if not isinstance(seq, Named):
                    continue
                items = seq.value
                qid = _name(named_get(items, "id"))
                inst = named_get(items, "inst", [])
                length = int(named_get(inst, "length", 0))
                data = named_get(inst, "seq-data")
                raw = None
                if isinstance(data, Named) and data.name == "ncbi4na":
                    raw = data.value
                arch.queries.append(ArchiveQuery(qid, length, raw))

    results = named_get(root, "results", [])
    for aln in named_get(results, "alignments", []):
        segs = named_get(aln, "segs")
        if not (isinstance(segs, Named) and segs.name == "denseg"):
            continue
        d = segs.value
        ids = named_get(d, "ids", [])
        qid, sid = _name(ids[0]), _name(ids[1])
        starts = [int(x) for x in named_get(d, "starts", [])]
        lens = [int(x) for x in named_get(d, "lens", [])]
        strands = named_get(d, "strands", [])
        minus = bool(strands) and str(strands[0]) == "minus"
        a = ArchiveAlignment(qid, sid, starts, lens, minus)
        for sc in named_get(aln, "score", []):
            nm = named_get(sc, "id")
            val = named_get(sc, "value")
            nm = str(nm.value if isinstance(nm, Named) else nm)
            v = val.value if isinstance(val, Named) else val
            if nm == "score":
                a.score = int(v)
            elif nm in ("e_value", "sum_e"):
                a.evalue = real_value(v)
            elif nm == "bit_score":
                a.bit_score = real_value(v)
            elif nm == "num_ident":
                a.num_ident = int(v)
        arch.alignments.append(a)
    return arch


_NCBI4NA_TO_BLASTNA = None


def _unpack_4na(raw: bytes, length: int) -> np.ndarray:
    """ncbi4na (2 bases/byte, first in high nibble) -> BLASTNA codes."""
    global _NCBI4NA_TO_BLASTNA
    if _NCBI4NA_TO_BLASTNA is None:
        from gblastn_tpu_torch.io.encoding import BLASTNA_TO_NCBI4NA

        inv = np.zeros(16, np.uint8)
        for b, na4 in enumerate(BLASTNA_TO_NCBI4NA):
            inv[na4] = b
        _NCBI4NA_TO_BLASTNA = inv
    b = np.frombuffer(raw, np.uint8)
    out = np.empty(2 * len(b), np.uint8)
    out[0::2] = b >> 4
    out[1::2] = b & 0xF
    return _NCBI4NA_TO_BLASTNA[out[:length]]


def alignment_to_hsp(a: ArchiveAlignment, qlen: int) -> HSP:
    """Rebuild the engine HSP (context-local query coords, edit script)
    from the dense-seg -- the inverse of objects.seqalign."""
    script: list[tuple[int, int]] = []
    q_plus_lo = q_plus_hi = None
    s_lo = s_hi = None
    for k, ln in enumerate(a.lens):
        qs, ss = a.starts[2 * k], a.starts[2 * k + 1]
        if qs != -1 and ss != -1:
            op = OP_SUB
        elif qs == -1:
            op = OP_DEL
        else:
            op = OP_INS
        if script and script[-1][0] == op:
            script[-1] = (op, script[-1][1] + ln)
        else:
            script.append((op, ln))
        if qs != -1:
            q_plus_lo = qs if q_plus_lo is None else min(q_plus_lo, qs)
            q_plus_hi = (
                qs + ln if q_plus_hi is None else max(q_plus_hi, qs + ln)
            )
        if ss != -1:
            s_lo = ss if s_lo is None else min(s_lo, ss)
            s_hi = ss + ln if s_hi is None else max(s_hi, ss + ln)
    if a.minus:
        q_off = qlen - q_plus_hi
        q_end = qlen - q_plus_lo
    else:
        q_off, q_end = q_plus_lo, q_plus_hi
    h = HSP(
        q_off=int(q_off), q_end=int(q_end),
        s_off=int(s_lo), s_end=int(s_hi),
        score=a.score, context=0,
        q_frame=-1 if a.minus else 1, s_frame=1,
    )
    h.evalue = a.evalue
    h.bit_score = a.bit_score
    h.num_ident = a.num_ident
    h.edit_script = script
    return h


def rebuild_results(arch: Archive, db, options):
    """Reconstruct a BlastResults (QueryBlock + per-query HSPLists +
    derived params) from an archive, for rendering through the same
    writer stack as a live search."""
    from gblastn_tpu_torch.engine.search import BlastResults, QueryResult
    from gblastn_tpu_torch.hits import HSPList
    from gblastn_tpu_torch.io.encoding import blastna_to_seq
    from gblastn_tpu_torch.io.fasta import FastaRecord
    from gblastn_tpu_torch.io.query import build_query_block
    from gblastn_tpu_torch.params.derived import derive_params

    records = [
        FastaRecord(q.qid, "", blastna_to_seq(
            _unpack_4na(q.ncbi4na, q.length)
        ))
        for q in arch.queries
    ]
    qblock = build_query_block(records, options.strand)
    params = derive_params(
        options, [c.length for c in qblock.contexts],
        int(db.total_length), db.num_seqs,
    )
    n_ctx_per_q = 2 if options.strand == "both" else 1
    oid_of = {sid: i for i, sid in enumerate(db.ids)}
    qi_of = {q.qid: i for i, q in enumerate(arch.queries)}

    results = BlastResults(qblock=qblock, params=params)
    per_query: dict[int, dict[int, HSPList]] = {}
    order: dict[int, list[int]] = {}
    for a in arch.alignments:
        qi = qi_of.get(a.qid)
        oid = oid_of.get(a.sid)
        if qi is None or oid is None:
            continue
        h = alignment_to_hsp(a, arch.queries[qi].length)
        h.context = qi * n_ctx_per_q + (
            1 if (a.minus and n_ctx_per_q == 2) else 0
        )
        h.q_frame = -1 if a.minus else 1
        lists = per_query.setdefault(qi, {})
        if oid not in lists:
            lists[oid] = HSPList(oid=oid, hsps=[])
            order.setdefault(qi, []).append(oid)
        lists[oid].hsps.append(h)
    for qi in range(len(arch.queries)):
        qres = QueryResult(query_index=qi)
        for oid in order.get(qi, []):
            lst = per_query[qi][oid]
            lst.best_evalue = min(h.evalue for h in lst.hsps)
            qres.hsplists.append(lst)
        results.queries.append(qres)
    return results


def format_archive(
    text: str,
    out,
    outfmt: str = "6",
    db=None,                     # SequenceDB override (tests)
    line_length: int = 60,
    num_descriptions: int = 500,
) -> int:
    """Re-render an archive with any -outfmt. Non-tabular kinds (and
    sequence-dependent tabular fields) need the archived database; the
    plain tabular kinds work from the archive alone."""
    from gblastn_tpu_torch.format.tabular import (
        DEFAULT_FIELDS,
        TabularWriter,
        hsp_to_tabular,
    )

    arch = read_archive(text)
    parts = outfmt.split()
    kind = int(parts[0])
    if kind not in (6, 7, 10):
        from gblastn_tpu_torch.format.render import ResultRenderer
        from gblastn_tpu_torch.objects.blast4 import strategy_to_args

        if db is None and arch.dbname:
            try:
                from gblastn_tpu_torch.io.seqdb import SequenceDB

                db = SequenceDB.load(arch.dbname)
            except Exception:
                db = None
        if db is None:
            raise ValueError(
                f"-outfmt {kind} needs the archived database "
                f"({arch.dbname!r}), which could not be opened; "
                "tabular 6/7/10 work from the archive alone"
            )
        saved = strategy_to_args(text)
        kw = {}
        for src, dst in (
            ("evalue", "evalue"), ("word_size", "word_size"),
            ("gapopen", "gap_open"), ("gapextend", "gap_extend"),
            ("penalty", "penalty"), ("reward", "reward"),
            ("strand", "strand"),
            ("window_size", "window_size"),
            ("template_length", "template_length"),
            ("template_type", "template_type"),
        ):
            if saved.get(src) not in (None, 0):
                kw[dst] = saved[src]
        from gblastn_tpu_torch.params.options import options_for_task

        options = options_for_task(saved.get("task", "megablast"), **kw)
        results = rebuild_results(arch, db, options)
        renderer = ResultRenderer(
            kind, parts[1:], out, db, options,
            dbname=arch.dbname, task=str(saved.get("task", "megablast")),
            line_length=line_length,
            num_descriptions=num_descriptions,
        )
        renderer.emit(results)
        renderer.finalize()
        return 0
    fields = parts[1:] or list(DEFAULT_FIELDS)
    writer = TabularWriter(
        out=out, fields=fields, commented=(kind == 7),
        dbname=arch.dbname, delimiter="," if kind == 10 else "\t",
    )

    if db is None and arch.dbname:
        try:
            from gblastn_tpu_torch.io.seqdb import SequenceDB

            db = SequenceDB.load(arch.dbname)
        except Exception:
            db = None
    need_seqs = writer.needs_sequences()
    oid_of = {}
    if db is not None:
        oid_of = {sid: i for i, sid in enumerate(db.ids)}
    if need_seqs and db is None:
        raise ValueError(
            "btop/qseq/sseq need the archived database "
            f"({arch.dbname!r}), which could not be opened"
        )
    if need_seqs and any(q.ncbi4na is None for q in arch.queries):
        raise ValueError(
            "btop/qseq/sseq need the query sequences, which this "
            "archive does not embed"
        )

    by_query: dict[str, list] = {q.qid: [] for q in arch.queries}
    for a in arch.alignments:
        by_query.setdefault(a.qid, []).append(a)
    qlen = {q.qid: q.length for q in arch.queries}
    qseq = {
        q.qid: _unpack_4na(q.ncbi4na, q.length)
        for q in arch.queries if q.ncbi4na is not None
    }

    for q in arch.queries:
        hits = []
        for a in by_query.get(q.qid, []):
            h = alignment_to_hsp(a, q.length)
            slen = 0
            stitle = ""
            subject = None
            q_ctx = None
            if db is not None and a.sid in oid_of:
                oid = oid_of[a.sid]
                slen = int(db.lengths[oid])
                stitle = (a.sid + " " + db.titles[oid]).strip()
                if need_seqs:
                    subject = db.get_sequence_blastna(oid)
            if need_seqs and q.qid in qseq:
                plus = qseq[q.qid]
                if h.q_frame < 0:
                    from gblastn_tpu_torch.io.encoding import (
                        reverse_complement_blastna,
                    )

                    q_ctx = reverse_complement_blastna(plus)
                else:
                    q_ctx = plus
            t = hsp_to_tabular(
                h, q.qid, a.sid, q.length, slen,
                stitle=stitle, q_ctx=q_ctx, subject=subject,
            )
            hits.append(t)
        writer.write_query_results(q.qid, q.qid, hits)
    writer.finalize(len(arch.queries))
    return 0
