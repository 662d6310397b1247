"""Blast4 object builders: search strategies + the outfmt-11 archive.

Reimplements the request/result object layer the reference uses for
``-export_search_strategy`` and ``-outfmt 11`` (reference:
NCBI c++/src/algo/blast/format/build_archive.cpp
(s_BuildArchiveAll), src/algo/blast/api/search_strategy.cpp
(CExportStrategy), and the ASN.1 modules
src/objects/blast/blast.asn, src/objects/seq/seq.asn,
src/objects/seqset/seqset.asn):

* ``Blast4-archive ::= { request Blast4-request, results
  Blast4-get-search-results-reply }`` (blast.asn:67-74);
* the request body is a ``queue-search`` Blast4-queue-search-request
  with program/service, the queries as a Bioseq-set (local ids, raw
  na Bioseqs with ncbi4na data -- CFastaReader conventions), the
  subject database name, and the algorithm options as Blast4-parameter
  name/value pairs (blast.asn:155-165, 544-547, 592-633);
* results carry the flattened Seq-align-set, per-query masks
  (packed-int Seq-locs, frame plus1 for nucleotide -- blast.asn:534),
  the ungapped+gapped Karlin-Altschul blocks, and the search-stats
  strings (build_archive.cpp:85-150).

Member tag numbers are the zero-based definition order of the cited
ASN.1 modules.
"""
from __future__ import annotations

import numpy as np

from gblastn_tpu_torch.io.encoding import BLASTNA_TO_NCBI4NA
from gblastn_tpu_torch.objects.asn1 import (
    Bool,
    Choice,
    Enum,
    Int,
    Member,
    Named,
    Octets,
    Of,
    Real,
    Seq,
    Str,
    named_get,
    real_value,
)
from gblastn_tpu_torch.objects.seqalign import seq_id_local

# Blast4-value CHOICE alternative tags (blast.asn:592-633)
VAL_BIG_INTEGER = 0
VAL_BOOLEAN = 2
VAL_CUTOFF = 3
VAL_INTEGER = 4
VAL_REAL = 6
VAL_STRAND = 10
VAL_STRING = 11
VAL_QUERY_MASK = 26

STRAND_TYPE = {"plus": 1, "minus": 2, "both": 3}
STRAND_NAME = {1: "forward-strand", 2: "reverse-strand",
               3: "both-strands"}


def b4_value(kind: str, value) -> Choice:
    """One Blast4-value alternative by name."""
    if kind == "integer":
        return Choice(Member("integer", VAL_INTEGER, Int(int(value))))
    if kind == "big-integer":
        return Choice(Member("big-integer", VAL_BIG_INTEGER,
                             Int(int(value))))
    if kind == "boolean":
        return Choice(Member("boolean", VAL_BOOLEAN, Bool(bool(value))))
    if kind == "real":
        return Choice(Member("real", VAL_REAL, Real(float(value))))
    if kind == "string":
        return Choice(Member("string", VAL_STRING, Str(str(value))))
    if kind == "cutoff-evalue":
        return Choice(Member("cutoff", VAL_CUTOFF, Choice(
            Member("e-value", 0, Real(float(value)))
        )))
    if kind == "strand-type":
        code = STRAND_TYPE[value] if isinstance(value, str) else int(value)
        return Choice(Member("strand-type", VAL_STRAND, Enum(
            STRAND_NAME[code], code
        )))
    raise ValueError(f"unknown Blast4-value kind {kind}")


def b4_parameter(name: str, kind: str, value) -> Seq:
    """Blast4-parameter { name, value } (blast.asn:544)."""
    return Seq([
        Member("name", 0, Str(name)),
        Member("value", 1, b4_value(kind, value)),
    ])


def algorithm_options(options) -> Of:
    """The Blast4-parameters list CExportStrategy emits for blastn
    (search_strategy.cpp x_Add* calls; see the golden
    unit_tests/api/data/archive.*.asn for the canonical set)."""
    params = [
        b4_parameter("EvalueThreshold", "cutoff-evalue", options.evalue),
        b4_parameter("HitlistSize", "integer",
                     options.max_target_seqs or options.hitlist_size),
        b4_parameter("UngappedMode", "boolean", not options.gapped),
        b4_parameter("GapOpeningCost", "integer", options.gap_open),
        b4_parameter("GapExtensionCost", "integer", options.gap_extend),
        b4_parameter(
            "FilterString", "string",
            ("L;m;" if options.dust else "F"),
        ),
        b4_parameter("WordSize", "integer", options.word_size),
        b4_parameter("EffectiveSearchSpace", "big-integer",
                     options.searchsp_override or 0),
        b4_parameter("WindowSize", "integer", options.window_size),
        b4_parameter("MismatchPenalty", "integer", options.penalty),
        b4_parameter("MatchReward", "integer", options.reward),
        b4_parameter("StrandOption", "strand-type", options.strand),
    ]
    if options.percent_identity:
        params.append(b4_parameter(
            "PercentIdentity", "real", options.percent_identity
        ))
    if options.best_hit_overhang:
        params.append(b4_parameter(
            "BestHitOverhang", "real", options.best_hit_overhang
        ))
    if options.best_hit_score_edge:
        params.append(b4_parameter(
            "BestHitScoreEdge", "real", options.best_hit_score_edge
        ))
    if options.culling_limit:
        params.append(b4_parameter(
            "CullingLimit", "integer", options.culling_limit
        ))
    if getattr(options, "use_index", False):
        # CExportStrategy emits MbIndexName for indexed megablast
        # (search_strategy.cpp x_AddParameterToProgramOptions)
        params.append(b4_parameter(
            "MbIndexName", "string", options.index_name or ""
        ))
    return Of(params, set_of=False)


# ------------------------------------------------------------- Bioseq

def _pack_ncbi4na(blastna: np.ndarray) -> bytes:
    nibbles = BLASTNA_TO_NCBI4NA[np.asarray(blastna, np.uint8)]
    if len(nibbles) % 2:
        nibbles = np.concatenate([nibbles, np.zeros(1, np.uint8)])
    return ((nibbles[0::2] << 4) | nibbles[1::2]).astype(np.uint8).tobytes()


def bioseq(sid: str, title: str, blastna_seq: np.ndarray) -> Seq:
    """A raw na Bioseq with local id + ncbi4na data (seq.asn:36-40,
    261-296; the shape CFastaReader produces for query input)."""
    members = [Member("id", 0, Of([seq_id_local(sid)], set_of=True))]
    if title:
        members.append(Member("descr", 1, Of([
            Choice(Member("title", 4, Str(title)))
        ], set_of=True)))
    members.append(Member("inst", 2, Seq([
        Member("repr", 0, Enum("raw", 2)),
        Member("mol", 1, Enum("na", 4)),
        Member("length", 2, Int(int(len(blastna_seq)))),
        Member("seq-data", 6, Choice(Member(
            "ncbi4na", 3, Octets(_pack_ncbi4na(blastna_seq))
        ))),
    ])))
    return Seq(members)


def bioseq_set(seqs: list) -> Seq:
    """Bioseq-set with only seq-set populated (seqset.asn:22-40)."""
    return Seq([
        Member("seq-set", 6, Of(
            [Choice(Member("seq", 0, s)) for s in seqs], set_of=False
        )),
    ])


# ----------------------------------------------------------- request

# Blast4-request-body CHOICE alternative tags (blast.asn:76-97)
BODY_QUEUE_SEARCH = 8


def queue_search_request(
    *, program: str, service: str, queries: Seq, subject_db: str,
    paramset: str, options,
) -> Seq:
    """Blast4-queue-search-request (blast.asn:155-165)."""
    return Seq([
        Member("program", 0, Str(program)),
        Member("service", 1, Str(service)),
        Member("queries", 2, Choice(Member("bioseq-set", 2, queries))),
        Member("subject", 3, Choice(Member("database", 0,
                                           Str(subject_db)))),
        Member("paramset", 4, Str(paramset)),
        Member("algorithm-options", 5, algorithm_options(options)),
    ])


def blast4_request(ident: str, queue_search: Seq) -> Seq:
    """Blast4-request { ident, body queue-search ... } (blast.asn:57)."""
    return Seq([
        Member("ident", 0, Str(ident)),
        Member("body", 1, Choice(Member(
            "queue-search", BODY_QUEUE_SEARCH, queue_search
        ))),
    ])


# ----------------------------------------------------------- results

def ka_block(Lambda: float, K: float, H: float, gapped: bool) -> Seq:
    """Blast4-ka-block (blast.asn:513); -1.0 fill when absent
    (build_archive.cpp:70-78)."""
    return Seq([
        Member("lambda", 0, Real(float(Lambda))),
        Member("k", 1, Real(float(K))),
        Member("h", 2, Real(float(H))),
        Member("gapped", 3, Bool(bool(gapped))),
    ])


def packed_int_loc(sid: str, intervals) -> Choice:
    """Seq-loc packed-int of (start, end) half-open intervals
    (seqloc.asn:75-97; Seq-interval to is INCLUSIVE)."""
    ivs = [
        Seq([
            Member("from", 0, Int(int(s))),
            Member("to", 1, Int(int(e) - 1)),
            Member("id", 3, seq_id_local(sid)),
        ])
        for s, e in intervals
    ]
    return Choice(Member("packed-int", 4, Of(ivs, set_of=False)))


def blast4_mask(sid: str, intervals) -> Seq:
    """Blast4-mask: one query's plus-strand masking locations
    (blast.asn:534; frame is plus1 for nucleotide queries per the
    convention note)."""
    return Seq([
        Member("locations", 0, Of(
            [packed_int_loc(sid, intervals)], set_of=False
        )),
        Member("frame", 1, Enum("plus1", 1)),
    ])


def search_results_reply(
    *, alignments: list, masks: list, ka_blocks: list,
    search_stats: list[str],
) -> Seq:
    """Blast4-get-search-results-reply (blast.asn:296-308)."""
    members = [Member("alignments", 0, Of(alignments, set_of=True))]
    if masks:
        members.append(Member("masks", 2, Of(masks, set_of=False)))
    members.append(Member("ka-blocks", 3, Of(ka_blocks, set_of=False)))
    members.append(Member("search-stats", 4, Of(
        [Str(s) for s in search_stats], set_of=False
    )))
    return Seq(members)


def blast4_archive(request: Seq, results: Seq) -> Seq:
    """Blast4-archive (blast.asn:67-74)."""
    return Seq([
        Member("request", 0, request),
        Member("results", 1, results),
    ])


def search_stats_strings(
    *, reward: int, penalty: int, gap_open: int, gap_extend: int,
    db_num_seqs: int, db_length: int, lookup_hits: int,
    init_extends: int, good_init_extends: int, gapped_extensions: int,
    num_seqs_better: int,
) -> list[str]:
    """The free-text stats block (build_archive.cpp:146-149 plus the
    traditional footer lines golden archives carry)."""
    return [
        f"Matrix: blastn matrix:{reward} {penalty}",
        f"Gap Penalties: Existence: {gap_open}, Extension: {gap_extend}",
        f"Number of Sequences: {db_num_seqs}",
        f"Number of Hits to DB: {lookup_hits}",
        f"Number of extensions: {init_extends}",
        f"Number of successful extensions: {good_init_extends}",
        f"Number of sequences better than 10: {num_seqs_better}",
        f"Number of HSP's gapped: {gapped_extensions}",
        f"Length of database: {db_length}",
        "",
    ]


# ------------------------------------------------- strategy recovery

def strategy_to_args(text: str) -> dict:
    """Recover CLI argument values from an exported Blast4-request
    (the RecoverSearchStrategy role, blast_app_util.cpp)."""
    from gblastn_tpu_torch.objects.asn1 import parse_text

    tname, val = parse_text(text)
    if tname == "Blast4-archive":
        val = named_get(val, "request")
    elif tname != "Blast4-request":
        raise ValueError(f"not a search strategy: {tname}")
    body = named_get(val, "body")
    if not isinstance(body, Named) or body.name != "queue-search":
        raise ValueError("strategy body is not queue-search")
    qs = body.value
    args: dict = {}
    args["task"] = named_get(qs, "paramset") or "megablast"
    subject = named_get(qs, "subject")
    if isinstance(subject, Named) and subject.name == "database":
        args["db"] = subject.value
    for p in named_get(qs, "algorithm-options") or []:
        name = named_get(p, "name")
        v = named_get(p, "value")
        inner = v.value if isinstance(v, Named) else v
        if name == "EvalueThreshold":
            cut = inner
            if isinstance(cut, Named):          # e-value REAL
                args["evalue"] = real_value(cut.value)
        elif name == "HitlistSize":
            args["max_target_seqs"] = int(inner)
        elif name == "UngappedMode":
            args["ungapped"] = bool(inner)
        elif name == "GapOpeningCost":
            args["gapopen"] = int(inner)
        elif name == "GapExtensionCost":
            args["gapextend"] = int(inner)
        elif name == "WordSize":
            args["word_size"] = int(inner)
        elif name == "WindowSize":
            args["window_size"] = int(inner)
        elif name == "MismatchPenalty":
            args["penalty"] = int(inner)
        elif name == "MatchReward":
            args["reward"] = int(inner)
        elif name == "PercentIdentity":
            args["perc_identity"] = real_value(inner)
        elif name == "CullingLimit":
            args["culling_limit"] = int(inner)
        elif name == "MbIndexName":
            args["use_index"] = "true"
            if inner:
                args["index_name"] = str(inner)
        elif name == "StrandOption":
            code = STRAND_TYPE.get(inner) if isinstance(inner, str) else None
            if inner == "forward-strand":
                args["strand"] = "plus"
            elif inner == "reverse-strand":
                args["strand"] = "minus"
            elif inner == "both-strands" or code == 3:
                args["strand"] = "both"
        elif name == "FilterString":
            args["dust"] = (
                "yes" if str(inner).startswith(("L", "D", "m", "T"))
                else "no"
            )
    return args
