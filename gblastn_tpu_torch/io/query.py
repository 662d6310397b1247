"""Concatenated query block with per-context bookkeeping.

The TPU analog of BLAST_SequenceBlk + BlastQueryInfo (reference:
NCBI c++/src/algo/blast/core/blast_query_info.c and
blast_setup.c): all queries and both strands are packed into one BLASTNA
buffer separated by sentinel bytes (code 15), so seeding scans one array
regardless of query count. Context order matches NCBI blastn: for query i,
context 2i is the plus strand, context 2i+1 the reverse-complemented minus
strand.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gblastn_tpu_torch.io.encoding import reverse_complement_blastna, seq_to_blastna
from gblastn_tpu_torch.io.fasta import FastaRecord

SENTINEL = 15


@dataclass(frozen=True)
class QueryContext:
    context: int
    query_index: int
    frame: int          # +1 or -1
    offset: int         # start of context in the concatenated buffer
    length: int
    is_valid: bool = True


@dataclass
class QueryBlock:
    """Concatenated BLASTNA buffer + contexts + per-query metadata."""

    buffer: np.ndarray                   # uint8, with sentinels
    contexts: list[QueryContext]
    ids: list[str]
    titles: list[str]
    lengths: list[int]                   # original per-query lengths
    # -soft_masking false: ``buffer`` carries the N-masked bases the
    # engine scores; this keeps the original letters for identity
    # counting and report display (sequence_nomask analog)
    buffer_nomask: np.ndarray | None = None

    @property
    def display_buffer(self) -> np.ndarray:
        return (
            self.buffer_nomask if self.buffer_nomask is not None
            else self.buffer
        )

    @property
    def num_queries(self) -> int:
        return len(self.ids)

    @property
    def concat_length(self) -> int:
        return len(self.buffer)

    def context_of_offset(self, offset: int) -> QueryContext:
        """Find the context containing a concatenated-buffer offset."""
        for ctx in self.contexts:
            if ctx.offset <= offset < ctx.offset + ctx.length:
                return ctx
        raise ValueError(f"offset {offset} not inside any context")

    def context_offsets(self) -> np.ndarray:
        """int32[n_ctx+1]: start offset per context, then len(buffer).

        The buffer ends with a trailing sentinel, so entry c+1 is always
        one past context c's trailing sentinel. Cached: called per
        HSPList in the traceback stage.
        """
        cached = self.__dict__.get("_ctx_off_cache")
        if cached is None or len(cached) != len(self.contexts) + 1:
            out = [c.offset for c in self.contexts]
            out.append(len(self.buffer))
            cached = np.array(out, dtype=np.int32)
            self.__dict__["_ctx_off_cache"] = cached
        return cached


def build_query_block(
    records: list[FastaRecord], strand: str = "both"
) -> QueryBlock:
    """Pack query records into one sentinel-separated BLASTNA buffer."""
    if strand not in ("both", "plus", "minus"):
        raise ValueError(f"bad strand {strand}")
    parts: list[np.ndarray] = [np.array([SENTINEL], dtype=np.uint8)]
    contexts: list[QueryContext] = []
    cursor = 1  # past leading sentinel
    ctx_id = 0
    ids, titles, lengths = [], [], []
    for qi, rec in enumerate(records):
        codes = seq_to_blastna(rec.sequence)
        ids.append(rec.seq_id)
        titles.append(rec.title)
        lengths.append(len(codes))
        strands: list[tuple[int, np.ndarray]] = []
        if strand in ("both", "plus"):
            strands.append((1, codes))
        if strand in ("both", "minus"):
            strands.append((-1, reverse_complement_blastna(codes)))
        for frame, arr in strands:
            contexts.append(
                QueryContext(
                    context=ctx_id,
                    query_index=qi,
                    frame=frame,
                    offset=cursor,
                    length=len(arr),
                    is_valid=len(arr) > 0,
                )
            )
            parts.append(arr)
            parts.append(np.array([SENTINEL], dtype=np.uint8))
            cursor += len(arr) + 1
            ctx_id += 1
    return QueryBlock(
        buffer=np.concatenate(parts),
        contexts=contexts,
        ids=ids,
        titles=titles,
        lengths=lengths,
    )
