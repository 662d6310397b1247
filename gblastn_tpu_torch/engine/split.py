"""Query splitting: oversized queries searched in overlapping chunks.

Reimplements the role of the reference's query-splitting machinery
(reference: NCBI c++/src/algo/blast/api/split_query_cxx.cpp,
split_query_aux_priv.cpp:54-74 overlap=100,
local_blast.cpp:62-100 chunk sizes: megablast 5 Mbase, blastn 1 Mbase;
env overrides CHUNK_SIZE / OVERLAP_CHUNK_SIZE honored the same way):
queries longer than the chunk size are searched as overlapping chunks
and per-chunk HSPs are mapped back to original coordinates and merged.

Merging happens at the PRELIM stage, as in the reference
(BlastHSPStreamMerge, blast_hspstream.c:380-510): chunk HSPs are
remapped to original-query context coordinates, overlap-strip HSP
pairs whose diagonals are within OVERLAP_DIAG_CLOSE are CONCATENATED
(s_BlastMergeTwoHSPs, blast_hits.c:1337: union of the two boxes,
score/gapped start from the higher scorer; off-diagonal pairs merge
only in gapped mode), and the merged prelim result runs through the
NORMAL traceback over the original query -- so an alignment spanning
a chunk boundary re-extends exactly as the reference's would
(Blast_HSPListsMerge, blast_hits.c:2545).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from gblastn_tpu_torch.hits import HSP, HSPList, sort_hsplists_by_evalue
from gblastn_tpu_torch.io.fasta import FastaRecord

CHUNK_MEGABLAST = 5_000_000
CHUNK_BLASTN = 1_000_000
OVERLAP = 100


def chunk_size_for_task(task: str) -> int:
    env = os.environ.get("CHUNK_SIZE")
    if env:
        return int(env)
    return CHUNK_MEGABLAST if task == "megablast" else CHUNK_BLASTN


def overlap_size() -> int:
    env = os.environ.get("OVERLAP_CHUNK_SIZE")
    if env:
        return int(env)
    return OVERLAP


@dataclass
class ChunkInfo:
    orig_index: int
    offset: int        # chunk start in the original query
    length: int
    orig_length: int


def split_records(
    records: list[FastaRecord], chunk_size: int, overlap: int
) -> tuple[list[FastaRecord], list[ChunkInfo], bool]:
    """Split oversized records into overlapping chunks. Returns
    (chunked_records, per-record ChunkInfo, any_split)."""
    out: list[FastaRecord] = []
    info: list[ChunkInfo] = []
    any_split = False
    for qi, rec in enumerate(records):
        L = rec.length
        if L <= chunk_size:
            out.append(rec)
            info.append(ChunkInfo(qi, 0, L, L))
            continue
        any_split = True
        step = chunk_size - overlap
        start = 0
        ci = 0
        while start < L:
            end = min(start + chunk_size, L)
            out.append(
                FastaRecord(
                    f"{rec.seq_id}__chunk{ci}", rec.title,
                    rec.sequence[start:end],
                )
            )
            info.append(ChunkInfo(qi, start, end - start, L))
            if end == L:
                break
            start += step
            ci += 1
    return out, info, any_split


def _remap_hsp(h: HSP, ci: ChunkInfo, n_ctx_per_query: int) -> HSP:
    """Map a chunk-local HSP to original-query context coordinates."""
    out = h.copy()
    if h.q_frame >= 0:
        shift = ci.offset
    else:
        # chunk minus strand maps into the original minus strand at
        # offset (orig_length - chunk_end)
        shift = ci.orig_length - (ci.offset + ci.length)
    out.q_off = h.q_off + shift
    out.q_end = h.q_end + shift
    out.q_gapped_start = h.q_gapped_start + shift
    ctx_in_query = h.context % n_ctx_per_query
    out.context = ci.orig_index * n_ctx_per_query + ctx_in_query
    return out


# Maximal diagonal distance between HSP endpoints within which
# overlap-strip HSPs from adjacent chunks are considered for merging
# (blast_hits.c OVERLAP_DIAG_CLOSE)
OVERLAP_DIAG_CLOSE = 10


def _merge_two_hsps(h1: HSP, h2: HSP, allow_gap: bool) -> bool:
    """s_BlastMergeTwoHSPs (blast_hits.c:1337): concatenate h2 into h1
    when their boxes intersect; True if merged (caller drops h2)."""
    if not allow_gap and (
        h1.s_off - h2.s_off - h1.q_off + h2.q_off
    ) != 0:
        return False
    if h1.s_frame != h2.s_frame:
        return False
    c_start = (
        h1.q_off <= h2.q_off <= h1.q_end
        and h1.s_off <= h2.s_off <= h1.s_end
    )
    c_end = (
        h1.q_off <= h2.q_end <= h1.q_end
        and h1.s_off <= h2.s_end <= h1.s_end
    )
    if not (c_start or c_end):
        return False
    h1.q_off = min(h1.q_off, h2.q_off)
    h1.s_off = min(h1.s_off, h2.s_off)
    h1.q_end = max(h1.q_end, h2.q_end)
    h1.s_end = max(h1.s_end, h2.s_end)
    if h2.score > h1.score:
        h1.q_gapped_start = h2.q_gapped_start
        h1.s_gapped_start = h2.s_gapped_start
        h1.score = h2.score
    return True


def _merge_lists(
    combined: list[HSP],
    new: list[HSP],
    split_plus: int,
    split_minus: int,
    overlap: int,
    allow_gap: bool,
) -> list[HSP]:
    """Blast_HSPListsMerge (blast_hits.c:2545) for one chunk boundary:
    overlap-strip candidate pairs whose relevant diagonals are within
    OVERLAP_DIAG_CLOSE try to concatenate; survivors combine, sorted
    by ScoreCompareHSPs."""
    from gblastn_tpu_torch.hits import score_sort_key

    cand1 = [
        h for h in combined
        if (h.q_frame >= 0 and h.q_end > split_plus)
        or (h.q_frame < 0 and h.q_off < split_minus + overlap)
    ]
    cand2 = [
        h for h in new
        if (h.q_frame >= 0 and h.q_off < split_plus + overlap)
        or (h.q_frame < 0 and h.q_end > split_minus)
    ]
    dropped: set[int] = set()
    for h1 in cand1:
        for h2 in cand2:
            if id(h2) in dropped or h1.context != h2.context:
                continue
            if h1.q_frame >= 0:
                end_diag = h1.q_end - h1.s_end
                start_diag = h2.q_off - h2.s_off
            else:
                end_diag = h2.q_end - h2.s_end
                start_diag = h1.q_off - h1.s_off
            if abs(end_diag - start_diag) < OVERLAP_DIAG_CLOSE:
                if _merge_two_hsps(h1, h2, allow_gap):
                    dropped.add(id(h2))
    out = combined + [h for h in new if id(h) not in dropped]
    out.sort(key=score_sort_key)
    return out


def merge_chunk_prelim(
    sub,                           # PrelimResult over chunked records
    info: list[ChunkInfo],
    num_orig: int,
    n_ctx_per_query: int,
    qblock_orig,
    params_orig,
    allow_gap: bool,
    overlap: int,
    hitlist_size: int,
):
    """Stitch per-chunk PRELIM results into a prelim result over the
    original queries (BlastHSPStreamMerge, blast_hspstream.c:380-510):
    remap HSPs to original coordinates, concatenate chunk-boundary
    HSPs, and rebuild per-query hitlists. The caller then runs the
    normal traceback over the ORIGINAL query block, so merged boxes
    re-extend exactly as unsplit ones."""
    from gblastn_tpu_torch.hits import HitList, hitlist_update

    # chunk indices per original query, ascending offset
    chunks_of: dict[int, list[int]] = {}
    for cqi, ci in enumerate(info):
        chunks_of.setdefault(ci.orig_index, []).append(cqi)
    for lst in chunks_of.values():
        lst.sort(key=lambda cqi: info[cqi].offset)

    hitlists = []
    masks_out = [] if sub.masks is not None else None
    for qi in range(num_orig):
        per_oid: dict[int, list[HSP]] = {}
        mask_iv: list[tuple[int, int]] = []
        for k, cqi in enumerate(chunks_of.get(qi, [])):
            ci = info[cqi]
            hl = sub.hitlists[cqi]
            if sub.masks is not None:
                for a, b in sub.masks[cqi]:
                    mask_iv.append((a + ci.offset, b + ci.offset))
            chunk_lists = {
                lst.oid: [
                    _remap_hsp(h, ci, n_ctx_per_query)
                    for h in lst.hsps
                ]
                for lst in hl.hsplists
            }
            if k == 0:
                per_oid = chunk_lists
                continue
            split_plus = ci.offset
            split_minus = ci.orig_length - ci.offset - overlap
            for oid, new in chunk_lists.items():
                if oid not in per_oid:
                    per_oid[oid] = new
                else:
                    per_oid[oid] = _merge_lists(
                        per_oid[oid], new, split_plus, split_minus,
                        overlap, allow_gap,
                    )
        hl_out = HitList(hitlist_size=hitlist_size)
        for oid in sorted(per_oid):
            hsps = per_oid[oid]
            if hsps:
                hitlist_update(hl_out, HSPList(oid=oid, hsps=hsps))
        sort_hsplists_by_evalue(hl_out.hsplists)
        hitlists.append(hl_out)
        if masks_out is not None:
            mask_iv.sort()
            merged_iv: list[tuple[int, int]] = []
            for a, b in mask_iv:
                if merged_iv and a <= merged_iv[-1][1]:
                    merged_iv[-1] = (
                        merged_iv[-1][0], max(merged_iv[-1][1], b)
                    )
                else:
                    merged_iv.append((a, b))
            masks_out.append(merged_iv)

    from gblastn_tpu_torch.engine.search import PrelimResult

    return PrelimResult(
        qblock=qblock_orig, params=params_orig, hitlists=hitlists,
        masks=masks_out,
    )
