"""Repeats-database query filtering (-filtering_db).

Equivalent of the reference's repeat filter, which runs a
traditional-blastn search of each query against a database of repeat
elements and masks the aligned query spans like a lowercase mask
(Blast_FindRepeatFilterLoc, NCBI c++/src/algo/blast/api/
repeats_filter_cxx.cpp:315-375). Search parameter constants from
blast_filter.h:57-72; alignment spans are merged with
BlastSeqLocCombine's link rule (blast_filter.c:974-1002: merge when
``right + link > next_left`` on inclusive coords, link = 5).

We self-host: the repeat search runs through this package's own
engine on the batch's device (``search(..., device=)``), so the filter
runs on the same kernels as the search it masks; the repeat database's
resident copy is cached on its own ``SequenceDB``.
"""
from __future__ import annotations

REPEATS_SEARCH_PENALTY = -1
REPEATS_SEARCH_REWARD = 1
REPEATS_SEARCH_MINSCORE = 26
REPEATS_SEARCH_GAP_OPEN = 2
REPEATS_SEARCH_GAP_EXTEND = 1
REPEATS_SEARCH_WORD_SIZE = 11
REPEATS_SEARCH_XDROP_UNGAPPED = 40.0
REPEATS_SEARCH_XDROP_FINAL = 90.0
REPEAT_MASK_LINK_VALUE = 5


_REPEAT_DB_CACHE: dict[str, object] = {}


def load_repeat_db(path):
    """Load (and cache) the repeats database; native or NCBI format."""
    db = _REPEAT_DB_CACHE.get(str(path))
    if db is None:
        from gblastn_tpu_torch.io.seqdb import SequenceDB

        db = SequenceDB.load(path)
        _REPEAT_DB_CACHE[str(path)] = db
    return db


def repeats_search_options():
    """s_CreateRepeatsSearchOptions (repeats_filter_cxx.cpp:315):
    traditional blastn defaults with the repeat-search constants; dust
    off; hit cutoff by raw score 26, not e-value."""
    from gblastn_tpu_torch.params.options import blastn_options

    return blastn_options(
        reward=REPEATS_SEARCH_REWARD,
        penalty=REPEATS_SEARCH_PENALTY,
        gap_open=REPEATS_SEARCH_GAP_OPEN,
        gap_extend=REPEATS_SEARCH_GAP_EXTEND,
        word_size=REPEATS_SEARCH_WORD_SIZE,
        cutoff_score=REPEATS_SEARCH_MINSCORE,
        x_dropoff_ungapped=REPEATS_SEARCH_XDROP_UNGAPPED,
        gap_x_dropoff_final=REPEATS_SEARCH_XDROP_FINAL,
        dust=False,
    )


def combine_intervals(
    intervals: list[tuple[int, int]], link: int = REPEAT_MASK_LINK_VALUE
) -> list[tuple[int, int]]:
    """Merge inclusive (left, right) intervals closer than ``link``
    (BlastSeqLocCombine, blast_filter.c:974)."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [intervals[0]]
    for left, right in intervals[1:]:
        pl, pr = out[-1]
        if pr + link > left:
            out[-1] = (pl, max(pr, right))
        else:
            out.append((left, right))
    return out


def find_repeat_masks(records, repeat_db,
                      device="cuda") -> list[list[tuple[int, int]]]:
    """Per-record plus-strand inclusive masked ranges from a repeat-db
    search on ``device`` (s_FillMaskLocFromBlastResults /
    s_SeqAlignToBlastSeqLoc: each alignment contributes its whole query
    extent)."""
    from gblastn_tpu_torch.engine.search import search

    res = search(list(records), repeat_db, repeats_search_options(),
                 device=device)
    lengths = [r.length for r in records]
    masks: list[list[tuple[int, int]]] = [[] for _ in records]
    for qres in res.queries:
        qlen = lengths[qres.query_index]
        spans = masks[qres.query_index]
        for lst in qres.hsplists:
            for h in lst.hsps:
                if h.q_frame >= 0:
                    spans.append((h.q_off, h.q_end - 1))
                else:
                    spans.append((qlen - h.q_end, qlen - h.q_off - 1))
    return [combine_intervals(m) for m in masks]


def query_repeat_masks(qblock, records, repeat_db, device="cuda"):
    """Repeat masks per context in concatenated-buffer coordinates
    (plus-strand intervals mirrored onto minus contexts, like
    query_dust_masks), from the nested search on ``device``."""
    per_query = find_repeat_masks(records, repeat_db, device)
    masks: list[list[tuple[int, int]]] = []
    for ctx in qblock.contexts:
        intervals = per_query[ctx.query_index]
        L = ctx.length
        ctx_masks: list[tuple[int, int]] = []
        for a, b in intervals:
            if ctx.frame >= 0:
                ctx_masks.append((ctx.offset + a, ctx.offset + b))
            else:
                ctx_masks.append(
                    (ctx.offset + L - 1 - b, ctx.offset + L - 1 - a)
                )
        ctx_masks.sort()
        masks.append(ctx_masks)
    return masks
