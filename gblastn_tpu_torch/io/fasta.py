"""FASTA reading/writing and query batching.

Host-side replacement for the reference's CBlastFastaInputSource /
CBlastInput batching layer (reference:
NCBI c++/src/algo/blast/blastinput/blast_input_aux.cpp:66-123 for
the batch-size policy; blast_input.cpp for GetNextSeqBatch).
"""
from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import Iterable, Iterator, TextIO


@dataclass
class FastaRecord:
    seq_id: str
    title: str
    sequence: bytes  # raw IUPAC letters, no whitespace

    @property
    def length(self) -> int:
        return len(self.sequence)


def parse_fasta(source: str | os.PathLike | TextIO | bytes) -> Iterator[FastaRecord]:
    """Stream FASTA records from a path, file object, or bytes."""
    if isinstance(source, bytes):
        fh: TextIO = io.StringIO(source.decode("ascii"))
        close = False
    elif isinstance(source, (str, os.PathLike)):
        fh = open(source, "rt")
        close = True
    else:
        fh = source
        close = False
    try:
        seq_id = None
        title = ""
        chunks: list[bytes] = []
        n_anon = 0
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if seq_id is not None:
                    yield FastaRecord(seq_id, title, b"".join(chunks))
                header = line[1:].strip()
                if header:
                    parts = header.split(None, 1)
                    seq_id = parts[0]
                    title = parts[1] if len(parts) > 1 else ""
                else:
                    n_anon += 1
                    seq_id = f"Query_{n_anon}"
                    title = ""
                chunks = []
            else:
                if seq_id is None:
                    n_anon += 1
                    seq_id = f"Query_{n_anon}"
                    title = ""
                chunks.append(line.replace(" ", "").encode("ascii"))
        if seq_id is not None:
            yield FastaRecord(seq_id, title, b"".join(chunks))
    finally:
        if close:
            fh.close()


# Default query batch sizes by task (GetQueryBatchSize,
# blast_input_aux.cpp:66-123): megablast 5 Mbase, blastn 100 kbase.
BATCH_SIZE_MEGABLAST = 5_000_000
BATCH_SIZE_BLASTN = 100_000


def batch_records(
    records: Iterable[FastaRecord], batch_size_residues: int
) -> Iterator[list[FastaRecord]]:
    """Group records into batches by total residue count; a batch always
    holds at least one record (CBlastInput::GetNextSeqBatch semantics)."""
    batch: list[FastaRecord] = []
    total = 0
    for rec in records:
        batch.append(rec)
        total += rec.length
        if total >= batch_size_residues:
            yield batch
            batch, total = [], 0
    if batch:
        yield batch


@dataclass
class BatchSizeMixer:
    """Adaptive batch sizing targeting a fixed number of hits per batch
    (CBatchSizeMixer, used by the pipelined blastn app,
    blastn_app.cpp:574-577). The mixer adjusts the residue budget from the
    observed hits-per-residue ratio of completed batches."""

    target_hits: int = 2_000_000
    batch_size: int = BATCH_SIZE_MEGABLAST
    min_size: int = 100_000
    max_size: int = 20_000_000
    _ratio: float = field(default=-1.0, repr=False)

    def update(self, hits: int, residues: int) -> int:
        if residues > 0:
            r = hits / residues
            self._ratio = r if self._ratio < 0 else 0.5 * (self._ratio + r)
            if self._ratio > 0:
                self.batch_size = int(
                    min(self.max_size,
                        max(self.min_size, self.target_hits / self._ratio))
                )
        return self.batch_size
