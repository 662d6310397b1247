"""Text / binary ASN.1 Seq-annot output (-outfmt 8 / 9).

One ``Seq-annot`` per query with alignments, exactly like the
reference's structured-report path (reference:
NCBI c++/src/algo/blast/format/blast_format.cpp:516-532
``x_PrintStructuredReport``: MSerial_AsnText / MSerial_AsnBinary of
``x_WrapAlignmentInSeqAnnot``); queries without alignments emit
nothing. The Seq-annot wrapper and per-HSP Seq-align construction live
in gblastn_tpu_torch.objects.seqalign.
"""
from __future__ import annotations

from dataclasses import dataclass

from gblastn_tpu_torch.objects.asn1 import to_ber, to_text
from gblastn_tpu_torch.objects.seqalign import seq_align, seq_annot


@dataclass
class AsnWriter:
    out: object                  # text stream (8) or binary stream (9)
    binary: bool = False
    task: str = "megablast"
    db_title: str = ""

    def write_query_results(
        self, query_id: str, hits, context_lengths
    ) -> None:
        """``hits``: list of (subject_id, hsps); ``context_lengths``:
        context -> query context length for strand conversion."""
        aligns = []
        for sid, hsps in hits:
            for h in hsps:
                aligns.append(seq_align(
                    h, query_id, sid, context_lengths[h.context]
                ))
        if not aligns:
            return
        annot = seq_annot(aligns, task=self.task, db_title=self.db_title)
        if self.binary:
            self.out.write(to_ber(annot))
        else:
            self.out.write(to_text("Seq-annot", annot))

    def finalize(self, num_queries: int) -> None:
        pass
