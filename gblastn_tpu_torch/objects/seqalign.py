"""Seq-align object model: HSP -> Dense-seg Seq-align conversion.

Reimplements the BLAST engine-to-object bridge (reference:
NCBI c++/src/algo/blast/api/blast_seqalign.cpp):

* segment collection walks the traceback edit script; substitution
  runs advance both rows, OP_INS (gap in subject) advances only the
  query row, OP_DEL only the subject row, gap rows carry start -1
  (s_CollectSeqAlignData, :150-256);
* minus-strand query segments convert the context-local (revcomped)
  running offset to plus-strand starts via length - pos - num
  (s_GetAlignmentStart, :113-138), and the strand of a leading gap
  segment is `unknown` (:225, :238);
* the score list order is score, [sum_n], e_value|sum_e, bit_score,
  num_ident (s_BuildScoreList, :935-972) with e-values below 1e-180
  clamped to 0;
* alignments are type partial, dim 2 (s_CreateDenseg, :270-300).

Member tag numbers in the builders come from the reference ASN.1
modules: objects/seqalign/seqalign.asn (Seq-align, Dense-seg, Score),
objects/seqloc/seqloc.asn (Seq-id, Na-strand), objects/general/
general.asn (Object-id), objects/seq/seq.asn (Seq-annot).
"""
from __future__ import annotations

from gblastn_tpu_torch.hits import HSP, OP_DEL, OP_INS, OP_SUB
from gblastn_tpu_torch.objects.asn1 import (
    Bool,
    Choice,
    Enum,
    Int,
    Member,
    Of,
    Real,
    Seq,
    Str,
)

SMALLEST_EVALUE = 1.0e-180
GAP = -1

STRAND_UNKNOWN = Enum("unknown", 0)
STRAND_PLUS = Enum("plus", 1)
STRAND_MINUS = Enum("minus", 2)


def seq_id_local(sid: str) -> Choice:
    """Seq-id ::= CHOICE { local Object-id ... } with a str Object-id
    (or id when the string is a plain integer, matching CSeq_id's
    behaviour for numeric local ids)."""
    if sid.isdigit() and sid[0] != "0":
        obj = Choice(Member("id", 0, Int(int(sid))))
    else:
        obj = Choice(Member("str", 1, Str(sid)))
    return Choice(Member("local", 0, obj))


def _score(name: str, value) -> Seq:
    val = (
        Choice(Member("int", 1, Int(value)))
        if isinstance(value, int)
        else Choice(Member("real", 0, Real(value)))
    )
    return Seq([
        Member("id", 0, Choice(Member("str", 1, Str(name)))),
        Member("value", 1, val),
    ])


def score_set(hsp: HSP) -> Of:
    """s_BuildScoreList (blast_seqalign.cpp:935)."""
    scores = []
    if hsp.score:
        scores.append(_score("score", int(hsp.score)))
    if hsp.num > 1:
        scores.append(_score("sum_n", int(hsp.num)))
    evalue = 0.0 if hsp.evalue < SMALLEST_EVALUE else float(hsp.evalue)
    scores.append(_score(
        "e_value" if hsp.num <= 1 else "sum_e", evalue
    ))
    if hsp.bit_score >= 0.0:
        scores.append(_score("bit_score", float(hsp.bit_score)))
    if hsp.num_ident >= 0:
        scores.append(_score("num_ident", int(hsp.num_ident)))
    return Of(scores, set_of=True)


def collect_segments(hsp: HSP, query_length: int):
    """(starts, lens, strands) triples per s_CollectSeqAlignData.

    ``query_length`` is the CONTEXT length; minus-strand starts are
    converted to plus-strand coordinates. Subject is always plus.
    Returns flat lists: starts/strands have 2 entries per segment.
    """
    script = hsp.edit_script or [(OP_SUB, hsp.q_end - hsp.q_off)]
    minus = hsp.q_frame < 0
    q_strand = STRAND_MINUS if minus else STRAND_PLUS
    starts: list[int] = []
    lens: list[int] = []
    strands = []
    q_pos = hsp.q_off
    s_pos = hsp.s_off

    for idx, (op, num) in enumerate(script):
        if num == 0:
            continue
        if op == OP_SUB:
            q_start = (
                query_length - q_pos - num if minus else q_pos
            )
            starts.extend([q_start, s_pos])
            strands.extend([q_strand, STRAND_PLUS])
            q_pos += num
            s_pos += num
        elif op == OP_INS:        # consumes query, gap in subject
            q_start = (
                query_length - q_pos - num if minus else q_pos
            )
            starts.extend([q_start, GAP])
            strands.extend([
                q_strand,
                STRAND_UNKNOWN if idx == 0 else STRAND_PLUS,
            ])
            q_pos += num
        elif op == OP_DEL:        # consumes subject, gap in query
            starts.extend([GAP, s_pos])
            strands.extend([
                STRAND_UNKNOWN if idx == 0 else q_strand,
                STRAND_PLUS,
            ])
            s_pos += num
        else:
            continue
        lens.append(num)
    return starts, lens, strands


def denseg(query_id: str, subject_id: str, starts, lens, strands) -> Seq:
    return Seq([
        Member("dim", 0, Int(2)),
        Member("numseg", 1, Int(len(lens))),
        Member("ids", 2, Of(
            [seq_id_local(query_id), seq_id_local(subject_id)],
            set_of=False,
        )),
        Member("starts", 3, Of([Int(s) for s in starts], set_of=False)),
        Member("lens", 4, Of([Int(n) for n in lens], set_of=False)),
        Member("strands", 5, Of(list(strands), set_of=False)),
    ])


def seq_align(
    hsp: HSP, query_id: str, subject_id: str, query_length: int
) -> Seq:
    """One HSP as a Seq-align (type partial, dim 2, denseg segs)."""
    starts, lens, strands = collect_segments(hsp, query_length)
    return Seq([
        Member("type", 0, Enum("partial", 3)),
        Member("dim", 1, Int(2)),
        Member("score", 2, score_set(hsp)),
        Member("segs", 3, Choice(Member(
            "denseg", 1, denseg(query_id, subject_id, starts, lens,
                                strands),
        ))),
    ])


def object_id(val) -> Choice:
    if isinstance(val, int):
        return Choice(Member("id", 0, Int(val)))
    return Choice(Member("str", 1, Str(val)))


def user_field(label: str, value) -> Seq:
    """User-field (general.asn:133-148)."""
    if isinstance(value, bool):
        data = Choice(Member("bool", 3, Bool(value)))
    elif isinstance(value, int):
        data = Choice(Member("int", 1, Int(value)))
    else:
        data = Choice(Member("str", 0, Str(str(value))))
    return Seq([
        Member("label", 0, object_id(label)),
        Member("data", 2, data),
    ])


def user_object(type_str: str, fields: list) -> Seq:
    """User-object (general.asn:128-131)."""
    return Seq([
        Member("type", 1, object_id(type_str)),
        Member("data", 2, Of(fields, set_of=False)),
    ])


# EProgram values (blast_types.hpp:57-72) for the "Blast Type" desc
PROGRAM_ENUM = {"blastn": 1, "megablast": 7, "dc-megablast": 8}


def seq_annot(aligns: list, task: str = "", db_title: str = "") -> Seq:
    """Seq-annot with align data (seq.asn:457-476; outfmt 8/9).

    The three desc user objects mirror
    CBlastFormatUtil::CreateSeqAnnotFromSeqAlignSet
    (blastfmtutil.cpp:300-345): "Hist Seqalign" TRUE, "Blast Type"
    {task: EProgram}, "Blast Database Title" {title: is-nucleotide}.
    """
    members = []
    if task:
        descs = [
            Choice(Member("user", 4, user_object(
                "Hist Seqalign",
                [user_field("Hist Seqalign", True)],
            ))),
            Choice(Member("user", 4, user_object(
                "Blast Type",
                [user_field(task, PROGRAM_ENUM.get(task, 1))],
            ))),
            Choice(Member("user", 4, user_object(
                "Blast Database Title",
                [user_field(db_title or "n/a", bool(db_title))],
            ))),
        ]
        members.append(Member("desc", 3, Of(descs, set_of=True)))
    members.append(Member("data", 4, Choice(Member(
        "align", 1, Of(aligns, set_of=True),
    ))))
    return Seq(members)


def seq_align_set(aligns: list) -> Of:
    return Of(aligns, set_of=True)
