"""Tabular report writer (-outfmt 6/7), byte-compatible with NCBI BLAST.

Reimplements the tabular path of the reference formatter (reference:
NCBI c++/src/objtools/align_format/tabular.cpp and
align_format_util.cpp:669 ``CAlignFormatUtil::GetScoreString``):

* e-value / bit-score strings reproduce the exact snprintf bucket rules;
* percent identity is fixed 2-decimal (tabular.hpp:382);
* mismatches = align_length - num_ident - gaps (tabular.hpp:420);
* gap opens / gaps / align length follow Blast_HSPCalcLengthAndGaps
  (blast_hits.c:941);
* default fields are the "std" set of -outfmt '6'/'7';
* outfmt 7 comment blocks follow CBlastTabularInfo::PrintHeader
  (tabular.cpp:1043).

Coordinates are printed 1-based; minus-strand HSPs report plus-strand
query coordinates with subject start > end, as blastn does.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from gblastn_tpu_torch.hits import HSP, OP_DEL, OP_INS

DEFAULT_FIELDS = [
    "qseqid", "sseqid", "pident", "length", "mismatch", "gapopen",
    "qstart", "qend", "sstart", "send", "evalue", "bitscore",
]

FIELD_HEADER_NAMES = {
    "qseqid": "query id",
    "sseqid": "subject id",
    "pident": "% identity",
    "length": "alignment length",
    "mismatch": "mismatches",
    "gapopen": "gap opens",
    "qstart": "q. start",
    "qend": "q. end",
    "sstart": "s. start",
    "send": "s. end",
    "evalue": "evalue",
    "bitscore": "bit score",
    "score": "score",
    "nident": "identical",
    "gaps": "gaps",
    "qlen": "query length",
    "slen": "subject length",
    "sstrand": "subject strand",
    "frames": "query/sbjct frames",
    # extended specifiers (tabular.cpp sFieldMap / blast_formatter -help)
    "qgi": "query gi",
    "qacc": "query acc.",
    "qaccver": "query acc.ver",
    "sallseqid": "all subject ids",
    "sgi": "subject gi",
    "sallgi": "all subject gis",
    "sacc": "subject acc.",
    "saccver": "subject acc.ver",
    "sallacc": "all subject acc.",
    "stitle": "subject title",
    "salltitles": "all subject titles",
    "qframe": "query frame",
    "sframe": "sbjct frame",
    "positive": "positives",
    "ppos": "% positives",
    "btop": "BTOP",
    "qseq": "query seq",
    "sseq": "subject seq",
    "qcovs": "% query coverage per subject",
    "qcovhsp": "% query coverage per hsp",
}

PROGRAM_VERSION = "GBLASTN-TPU 0.1.0"


def percent_match(numerator: int, denominator: int) -> int:
    """CAlignFormatUtil::GetPercentMatch (reference:
    NCBI c++/src/objtools/align_format/
    align_format_util.cpp:2557): exact -> 100, otherwise round-half-up
    capped at 99 (a 199/200 alignment must print 99%, never 100%)."""
    if numerator == denominator:
        return 100
    if not denominator:
        return 0
    return min(99, int(0.5 + 100.0 * numerator / denominator))


def evalue_string(evalue: float) -> str:
    """GetScoreString e-value buckets (align_format_util.cpp:694-714)."""
    if evalue < 1.0e-180:
        return "0.0"
    if evalue < 1.0e-99:
        return f"{evalue:.0e}"
    if evalue < 0.0009:
        return f"{evalue:.0e}"
    if evalue < 0.1:
        return f"{evalue:.3f}"
    if evalue < 1.0:
        return f"{evalue:.2f}"
    if evalue < 10.0:
        return f"{evalue:.1f}"
    return f"{evalue:5.0f}"


def bit_score_string(bit_score: float) -> str:
    """GetScoreString bit-score buckets (align_format_util.cpp:716-724)."""
    if bit_score > 9999:
        return f"{bit_score:.3e}"
    if bit_score > 99.9:
        return f"{int(bit_score):4d}"
    return f"{bit_score:4.1f}"


def calc_length_and_gaps(hsp: HSP) -> tuple[int, int, int]:
    """Blast_HSPCalcLengthAndGaps (blast_hits.c:941).
    Returns (align_length, gaps, gap_opens)."""
    length = hsp.q_end - hsp.q_off
    s_length = hsp.s_end - hsp.s_off
    gap_opens = 0
    gaps = 0
    if hsp.edit_script:
        for op, num in hsp.edit_script:
            if op == OP_DEL:
                length += num
                gaps += num
                gap_opens += 1
            elif op == OP_INS:
                gap_opens += 1
                gaps += num
    elif s_length > length:
        length = s_length
    return length, gaps, gap_opens


@dataclass
class TabularHit:
    """One formatted alignment line's raw values."""

    qseqid: str
    sseqid: str
    num_ident: int
    align_length: int
    gaps: int
    gap_opens: int
    qstart: int
    qend: int
    sstart: int
    send: int
    evalue: float
    bit_score: float
    score: int = 0
    qlen: int = 0
    slen: int = 0
    sstrand: str = "plus"
    q_frame: int = 1
    stitle: str = ""
    qcovs: int = 0          # filled by fill_query_coverage
    # lazy-field inputs: the HSP plus BLASTNA views of the HSP's query
    # context and the whole subject (only set when the writer's field
    # list requests btop/qseq/sseq)
    hsp: HSP | None = None
    q_ctx: object = None
    subject: object = None


def hsp_to_tabular(
    hsp: HSP,
    qseqid: str,
    sseqid: str,
    query_length: int,
    subject_length: int,
    stitle: str = "",
    q_ctx=None,
    subject=None,
) -> TabularHit:
    """Convert a finished HSP (context-local coords) to report values."""
    align_length, gaps, gap_opens = calc_length_and_gaps(hsp)
    if hsp.q_frame >= 0:
        qstart = hsp.q_off + 1
        qend = hsp.q_end
        sstart = hsp.s_off + 1
        send = hsp.s_end
        strand = "plus"
    else:
        # minus-strand context: query coords flip to plus-strand
        # original coordinates, subject prints reversed
        qstart = query_length - hsp.q_end + 1
        qend = query_length - hsp.q_off
        sstart = hsp.s_end
        send = hsp.s_off + 1
        strand = "minus"
    return TabularHit(
        qseqid=qseqid, sseqid=sseqid,
        num_ident=hsp.num_ident, align_length=align_length,
        gaps=gaps, gap_opens=gap_opens,
        qstart=qstart, qend=qend, sstart=sstart, send=send,
        evalue=hsp.evalue, bit_score=hsp.bit_score, score=hsp.score,
        qlen=query_length, slen=subject_length,
        sstrand=strand, q_frame=1 if hsp.q_frame >= 0 else -1,
        stitle=stitle, hsp=hsp, q_ctx=q_ctx, subject=subject,
    )


def fill_query_coverage(hits: list[TabularHit]) -> None:
    """qcovs: percent of the query covered by the union of all HSPs
    from the same subject (CAlignFormatUtil::GetWholeAlnCoverageParams
    semantics, computed over merged plus-strand query ranges)."""
    by_subject: dict[str, list[TabularHit]] = {}
    for h in hits:
        by_subject.setdefault(h.sseqid, []).append(h)
    for group in by_subject.values():
        ivs = sorted((h.qstart, h.qend) for h in group)
        covered = 0
        cur_a, cur_b = ivs[0]
        for a, b in ivs[1:]:
            if a > cur_b + 1:
                covered += cur_b - cur_a + 1
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        covered += cur_b - cur_a + 1
        qlen = group[0].qlen or 1
        pct = int(covered * 100.0 / qlen + 0.5)
        for h in group:
            h.qcovs = pct


_COMP = str.maketrans("ACGTRYSWKMBDHVN-", "TGCAYRSWMKVHDBN-")

from gblastn_tpu_torch.hits import OP_DEL, OP_INS, OP_SUB  # noqa: E402


def _aligned_strings(hit: TabularHit) -> tuple[str, str]:
    """Gapped alignment strings in NCBI report orientation (query
    plus-strand; minus-strand hits reverse-complement both rows, the
    convention of the denseg blastn emits: query plus / subject
    minus)."""
    from gblastn_tpu_torch.io.encoding import blastna_to_seq

    h = hit.hsp
    if h is None or hit.q_ctx is None or hit.subject is None:
        raise ValueError(
            "btop/qseq/sseq need sequences at hsp_to_tabular time"
        )
    q = blastna_to_seq(hit.q_ctx[h.q_off: h.q_end])
    s = blastna_to_seq(hit.subject[h.s_off: h.s_end])
    script = h.edit_script
    if script is None:
        script = [(OP_SUB, max(len(q), len(s)))]
    qrow = []
    srow = []
    qi = si = 0
    for op, num in script:
        if op == OP_SUB:
            qrow.append(q[qi: qi + num])
            srow.append(s[si: si + num])
            qi += num
            si += num
        elif op == OP_DEL:        # consumes subject: gap in query
            qrow.append("-" * num)
            srow.append(s[si: si + num])
            si += num
        elif op == OP_INS:        # consumes query: gap in subject
            qrow.append(q[qi: qi + num])
            srow.append("-" * num)
            qi += num
    qstr = "".join(qrow)
    sstr = "".join(srow)
    if hit.q_frame < 0:
        qstr = qstr[::-1].translate(_COMP)
        sstr = sstr[::-1].translate(_COMP)
    return qstr, sstr


def _btop(qstr: str, sstr: str) -> str:
    """Blast traceback operations (tabular.cpp x_ComputeBTOP): runs of
    identities as counts, differences as query+subject letter pairs
    (gap = '-')."""
    out = []
    run = 0
    for qc, sc in zip(qstr, sstr):
        if qc == sc and qc != "-":
            run += 1
            continue
        if run:
            out.append(str(run))
            run = 0
        out.append(qc + sc)
    if run:
        out.append(str(run))
    return "".join(out) or "0"


def format_field(hit: TabularHit, name: str) -> str:
    if name == "qseqid":
        return hit.qseqid
    if name == "sseqid":
        return hit.sseqid
    if name == "pident":
        p = (
            hit.num_ident / hit.align_length * 100
            if hit.align_length > 0 else 0.0
        )
        return f"{p:.2f}"
    if name == "length":
        return str(hit.align_length)
    if name == "mismatch":
        return str(hit.align_length - hit.num_ident - hit.gaps)
    if name == "gapopen":
        return str(hit.gap_opens)
    if name == "gaps":
        return str(hit.gaps)
    if name == "nident":
        return str(hit.num_ident)
    if name == "qstart":
        return str(hit.qstart)
    if name == "qend":
        return str(hit.qend)
    if name == "sstart":
        return str(hit.sstart)
    if name == "send":
        return str(hit.send)
    if name == "evalue":
        return evalue_string(hit.evalue)
    if name == "bitscore":
        return bit_score_string(hit.bit_score)
    if name == "score":
        return str(hit.score)
    if name == "qlen":
        return str(hit.qlen)
    if name == "slen":
        return str(hit.slen)
    if name == "sstrand":
        return hit.sstrand
    if name in ("qacc", "qaccver"):
        return hit.qseqid
    if name in ("sacc", "saccver", "sallseqid", "sallacc"):
        return hit.sseqid
    if name in ("qgi", "sgi", "sallgi"):
        return "N/A"            # local ids carry no gi (tabular.cpp)
    if name in ("stitle", "salltitles"):
        return hit.stitle or "N/A"
    if name == "qframe":
        return "1"              # blastn reports minus on the subject
    if name == "sframe":
        return str(hit.q_frame)
    if name == "frames":
        return f"1/{hit.q_frame}"
    if name == "positive":
        return str(hit.num_ident)   # nucleotide: positives = identities
    if name == "ppos":
        p = (
            hit.num_ident / hit.align_length * 100
            if hit.align_length > 0 else 0.0
        )
        return f"{p:.2f}"
    if name == "qcovs":
        return str(hit.qcovs)
    if name == "qcovhsp":
        qspan = hit.qend - hit.qstart + 1
        return str(int(qspan * 100.0 / (hit.qlen or 1) + 0.5))
    if name == "qseq":
        return _aligned_strings(hit)[0]
    if name == "sseq":
        return _aligned_strings(hit)[1]
    if name == "btop":
        return _btop(*_aligned_strings(hit))
    raise ValueError(f"unsupported tabular field {name!r}")


@dataclass
class TabularWriter:
    """outfmt 6 (plain) / 7 (commented) / 10 (CSV) writer.

    outfmt 10 prints the identical field strings joined by ','
    (CBlastTabularInfo::Print with the eComma delimiter,
    tabular.cpp:121-129, :925-933) with no comment lines."""

    out: object                     # file-like
    fields: list[str] = field(default_factory=lambda: list(DEFAULT_FIELDS))
    commented: bool = False         # outfmt 7
    dbname: str = ""
    program: str = PROGRAM_VERSION
    delimiter: str = "\t"           # ',' for outfmt 10

    def needs_sequences(self) -> bool:
        """True when the field list includes alignment-string fields,
        so the caller must pass q_ctx/subject to hsp_to_tabular."""
        return bool({"btop", "qseq", "sseq"} & set(self.fields))

    def write_query_results(
        self, query_id: str, query_title: str, hits: list[TabularHit]
    ) -> None:
        if hits and "qcovs" in self.fields:
            fill_query_coverage(hits)
        if self.commented:
            self.out.write(f"# {self.program}\n")
            title = query_title or query_id
            self.out.write(f"# Query: {title}\n")
            self.out.write(f"# Database: {self.dbname}\n")
            if hits:
                names = ", ".join(FIELD_HEADER_NAMES[f] for f in self.fields)
                self.out.write(f"# Fields: {names}\n")
            self.out.write(f"# {len(hits)} hits found\n")
        for h in hits:
            self.out.write(
                self.delimiter.join(
                    format_field(h, f) for f in self.fields
                ) + "\n"
            )

    def finalize(self, num_queries: int) -> None:
        if self.commented:
            self.out.write(f"# BLAST processed {num_queries} queries\n")
