"""Shared result rendering: one writer facade over every -outfmt kind.

Extracted from the blastn CLI loop so the same code path renders both
live search results and Blast4-archive replays (blast_formatter), the
way the reference funnels both through CBlastFormat
(reference: NCBI c++/src/algo/blast/format/blast_format.cpp).
"""
from __future__ import annotations

from gblastn_tpu_torch.format.tabular import TabularWriter, hsp_to_tabular


class ResultRenderer:
    """Construct the writer for ``kind`` and emit per-batch results.

    ``kind``/``fields`` come from _parse_outfmt; ``dbname`` is the CLI
    -db/-subject string (archive + strategy metadata), ``db`` the open
    SequenceDB.
    """

    def __init__(self, kind, fields, out, db, options, dbname, task,
                 line_length=60, num_descriptions=500):
        self.kind = kind
        self.out = out
        self.db = db
        self.options = options
        self.num_queries = 0
        self.writer = None
        self.pairwise = self.sam = self.xmlw = None
        self.asnw = self.archw = self.anchored = None

        if kind == 5:
            from gblastn_tpu_torch.format.xmlout import XmlWriter

            self.xmlw = XmlWriter(
                out=out, dbname=db.title or dbname,
                params={
                    "expect": options.evalue,
                    "sc-match": options.reward,
                    "sc-mismatch": options.penalty,
                    "gap-open": options.gap_open,
                    "gap-extend": options.gap_extend,
                    "filter": "L;m;" if options.dust else "F",
                },
            )
        elif kind in (6, 7, 10):
            self.writer = TabularWriter(
                out=out,
                commented=(kind == 7),
                dbname=db.title or dbname,
                delimiter="," if kind == 10 else "\t",
            )
            if fields:
                self.writer.fields = fields
        elif kind in (8, 9):
            from gblastn_tpu_torch.format.asn1out import AsnWriter

            self.asnw = AsnWriter(
                out=out, binary=(kind == 9), task=task,
                db_title=db.title or dbname or "",
            )
        elif kind == 11:
            from gblastn_tpu_torch.format.archive import ArchiveWriter

            self.archw = ArchiveWriter(
                out=out, options=options,
                dbname=dbname or "",
                db_num_seqs=db.num_seqs,
                db_length=int(db.total_length),
                task=task,
            )
        elif kind == 0:
            from gblastn_tpu_torch.format.pairwise import PairwiseWriter

            self.pairwise = PairwiseWriter(
                out=out, dbname=db.title or dbname,
                db_num_seqs=db.num_seqs, db_length=db.total_length,
                line_length=line_length,
                num_descriptions=num_descriptions,
            )
            self.pairwise.write_header()
        elif kind in (1, 2, 3, 4):
            from gblastn_tpu_torch.format.anchored import AnchoredWriter

            self.anchored = AnchoredWriter(
                out=out,
                show_identities=kind in (1, 3),
                flat=kind in (3, 4),
                dbname=db.title or dbname,
                db_num_seqs=db.num_seqs, db_length=db.total_length,
                line_length=line_length,
            )
            self.anchored.write_header()
        else:
            from gblastn_tpu_torch.format.sam import SamWriter

            self.sam = SamWriter(
                out=out,
                references=[
                    (sid, int(n)) for sid, n in zip(db.ids, db.lengths)
                ],
            )
            self.sam.write_header()

    def emit(self, results) -> None:
        db = self.db
        options = self.options
        writer = self.writer
        pairwise, anchored = self.pairwise, self.anchored
        xmlw, asnw, archw, sam = (
            self.xmlw, self.asnw, self.archw, self.sam
        )
        qb = results.qblock
        ctx_off = qb.context_offsets()
        for qres in results.queries:
            qi = qres.query_index
            qid = qb.ids[qi]
            qtitle = (qid + " " + qb.titles[qi]).strip()
            qlen = qb.lengths[qi]
            if writer is not None:
                hits = []
                want_seqs = writer.needs_sequences()
                subj_cache: dict[int, object] = {}
                for lst in qres.hsplists:
                    sid = db.ids[lst.oid]
                    slen = int(db.lengths[lst.oid])
                    subj = None
                    if want_seqs:
                        if lst.oid not in subj_cache:
                            subj_cache[lst.oid] = (
                                db.get_sequence_blastna(lst.oid)
                            )
                        subj = subj_cache[lst.oid]
                    for h in lst.hsps:
                        q_ctx = None
                        if want_seqs:
                            c0 = int(ctx_off[h.context])
                            q_ctx = qb.display_buffer[
                                c0: c0 + qb.contexts[h.context].length
                            ]
                        hits.append(hsp_to_tabular(
                            h, qid, sid, qlen, slen,
                            stitle=(sid + " " + db.titles[lst.oid]
                                    ).strip(),
                            q_ctx=q_ctx, subject=subj,
                        ))
                writer.write_query_results(qid, qtitle, hits)
            elif pairwise is not None or anchored is not None:
                def get_query(ctx):
                    q0 = int(ctx_off[ctx])
                    return qb.display_buffer[
                        q0: q0 + qb.contexts[ctx].length
                    ]

                phits = []
                for lst in qres.hsplists:
                    subj = db.get_sequence_blastna(lst.oid)
                    phits.append((
                        db.ids[lst.oid], db.titles[lst.oid],
                        int(db.lengths[lst.oid]), lst.hsps, subj,
                    ))
                params = results.params
                ctx0 = qi * (
                    2 if options.strand == "both" else 1
                )
                if pairwise is not None:
                    pairwise.write_query_results(
                        qtitle, qlen, phits, get_query,
                        None, params.kbp_gap, params.kbp_ungap,
                        params.contexts[ctx0].eff_searchsp,
                    )
                else:
                    anchored.write_query_results(
                        qid, qtitle, qlen, phits, get_query,
                        params.kbp_gap, params.kbp_ungap,
                        params.contexts[ctx0].eff_searchsp,
                    )
            elif xmlw is not None:
                def get_query(ctx):
                    q0 = int(ctx_off[ctx])
                    return qb.display_buffer[
                        q0: q0 + qb.contexts[ctx].length
                    ]

                if self.num_queries == 0:
                    xmlw.write_prolog(qid, qtitle, qlen)
                xhits = []
                for lst in qres.hsplists:
                    xhits.append((
                        db.ids[lst.oid], db.titles[lst.oid],
                        int(db.lengths[lst.oid]), lst.hsps,
                        db.get_sequence_blastna(lst.oid),
                    ))
                params = results.params
                ctx0 = qi * (
                    2 if options.strand == "both" else 1
                )
                kbp = params.kbp_gap
                xmlw.write_iteration(
                    qid, qtitle, qlen, xhits, get_query,
                    params.contexts[ctx0].eff_searchsp,
                    kbp.K, kbp.Lambda, kbp.H,
                )
            elif asnw is not None:
                ctx_lengths = {
                    c: qb.contexts[c].length
                    for c in range(len(qb.contexts))
                }
                asnw.write_query_results(
                    qid,
                    [(db.ids[lst.oid], lst.hsps)
                     for lst in qres.hsplists],
                    ctx_lengths,
                )
            elif archw is not None:
                n_ctx_per_q = (
                    2 if options.strand == "both" else 1
                )
                ctx0 = qi * n_ctx_per_q
                q0 = int(ctx_off[ctx0])
                mask_ivs = []
                if results.masks:
                    mask_ivs = [
                        (f - q0, t - q0 + 1)
                        for f, t in results.masks[ctx0]
                    ]
                archw.add_query(
                    qid, qb.titles[qi],
                    qb.display_buffer[q0: q0 + qb.contexts[ctx0].length],
                    mask_ivs,
                )
                ctx_lengths = {
                    c: qb.contexts[c].length
                    for c in range(len(qb.contexts))
                }
                archw.add_alignments(
                    qid,
                    [(db.ids[lst.oid], lst.hsps)
                     for lst in qres.hsplists],
                    ctx_lengths,
                )
                archw.set_ka(
                    results.params.kbp_ungap, results.params.kbp_gap
                )
            else:
                for lst in qres.hsplists:
                    sid = db.ids[lst.oid]
                    for h in lst.hsps:
                        ctx = h.context
                        q0 = int(ctx_off[ctx])
                        qseq = qb.display_buffer[
                            q0: q0 + qb.contexts[ctx].length
                        ]
                        sam.write_hsp(h, qid, sid, qseq, qlen)
            self.num_queries += 1

    def finalize(self) -> None:
        if self.writer is not None:
            self.writer.finalize(self.num_queries)
        elif self.pairwise is not None:
            self.pairwise.finalize()
        elif self.xmlw is not None:
            self.xmlw.finalize()
        elif self.archw is not None:
            self.archw.finalize(self.num_queries)
        elif self.anchored is not None:
            self.anchored.finalize()
