"""BLAST archive output (-outfmt 11).

Accumulates every query's Bioseq, alignments and masking locations
across batches and writes ONE ``Blast4-archive`` text object at
finalize, exactly like the reference's archive path (reference:
NCBI c++/src/algo/blast/format/blast_format.cpp:768
``CBlastFormat::WriteArchive`` -> build_archive.cpp
``s_BuildArchiveAll``): the request embeds the queries and options
(reformattable later by blast_formatter), the results carry the
flattened Seq-align-set, masks, the two KA blocks (first result's,
ungapped then gapped) and the search-stats strings.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from gblastn_tpu_torch.objects.asn1 import to_text
from gblastn_tpu_torch.objects.blast4 import (
    bioseq,
    bioseq_set,
    blast4_archive,
    blast4_mask,
    blast4_request,
    ka_block,
    queue_search_request,
    search_results_reply,
    search_stats_strings,
)
from gblastn_tpu_torch.objects.seqalign import seq_align

IDENT = "blastn: 2.2.28+ (gblastn-tpu)"


@dataclass
class ArchiveWriter:
    out: object
    options: object                 # SearchOptions
    dbname: str
    db_num_seqs: int
    db_length: int
    task: str = "megablast"

    _bioseqs: list = field(default_factory=list)
    _aligns: list = field(default_factory=list)
    _masks: list = field(default_factory=list)
    _ka: list | None = None
    _num_seqs_better: int = 0

    def add_query(self, qid, title, blastna_plus, mask_intervals):
        """Register one query: its plus-strand BLASTNA sequence and
        query-local half-open mask intervals (may be empty)."""
        self._bioseqs.append(bioseq(qid, title, blastna_plus))
        if mask_intervals:
            self._masks.append(blast4_mask(qid, mask_intervals))

    def add_alignments(self, qid, hits, context_lengths):
        """``hits``: list of (subject_id, hsps) for one query."""
        any_hit = False
        for sid, hsps in hits:
            for h in hsps:
                any_hit = True
                self._aligns.append(seq_align(
                    h, qid, sid, context_lengths[h.context]
                ))
        if any_hit:
            self._num_seqs_better += 1

    def set_ka(self, kbp_ungap, kbp_gap):
        """First result's Karlin blocks (build_archive.cpp:118-127)."""
        if self._ka is None:
            self._ka = [
                ka_block(kbp_ungap.Lambda, kbp_ungap.K, kbp_ungap.H,
                         False),
                ka_block(kbp_gap.Lambda, kbp_gap.K, kbp_gap.H, True),
            ]

    def finalize(self, num_queries: int) -> None:
        from gblastn_tpu_torch.utils.profiling import slog

        d = slog.diagnostics
        opts = self.options
        request = blast4_request(IDENT, queue_search_request(
            program="blastn",
            service="megablast" if self.task == "megablast" else "plain",
            queries=bioseq_set(self._bioseqs),
            subject_db=self.dbname,
            paramset=self.task,
            options=opts,
        ))
        results = search_results_reply(
            alignments=self._aligns,
            masks=self._masks,
            ka_blocks=self._ka or [],
            search_stats=search_stats_strings(
                reward=opts.reward, penalty=opts.penalty,
                gap_open=opts.gap_open, gap_extend=opts.gap_extend,
                db_num_seqs=self.db_num_seqs, db_length=self.db_length,
                lookup_hits=d.lookup_hits,
                init_extends=d.init_extends,
                good_init_extends=d.good_init_extends,
                gapped_extensions=d.gapped_extensions,
                num_seqs_better=self._num_seqs_better,
            ),
        )
        self.out.write(to_text(
            "Blast4-archive", blast4_archive(request, results)
        ))
