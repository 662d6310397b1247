"""Query-anchored alignment views (-outfmt 1/2/3/4).

The role of the reference's merged-alignment display (reference:
NCBI c++/src/objtools/align_format/showalign.cpp
``CDisplaySeqalign`` with ``eMergeAlign`` — outfmt 1/2 add
``eShowIdentity``, 3/4 the flat variant; option mapping in
src/algo/blast/format/blast_format.cpp:103-121): every HSP becomes a
row under a master line built from the plus-strand query, rendered in
60-column blocks.

Where the reference funnels the Seq-aligns through the CAlnMix merger,
this reimplementation anchors columns directly on plus-strand query
positions from the HSP edit scripts:

* modes 1/2 expand the master with '-' columns at query positions
  where any displayed row inserts subject bases (the merged-MSA
  behaviour); rows without an insertion show '-' there;
* flat modes 3/4 keep the master unexpanded; subject insertions
  relative to the query are not displayed (their bases are absorbed,
  matching the flat view's fixed query coordinates);
* modes 1/3 draw subject residues identical to the master as '.'
  (eShowIdentity); 2/4 always draw letters;
* minus-strand hits display the reverse-complemented subject under
  the plus-strand master with descending subject coordinates.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gblastn_tpu_torch.format.pairwise import _expand_alignment
from gblastn_tpu_torch.format.tabular import bit_score_string, evalue_string

LINE = 60
_COMP = str.maketrans("ACGTRYMKWSBDHVN", "TGCAYRKMWSVHDBN")


def _hsp_row(hsp, query: np.ndarray, subject: np.ndarray, qlen: int):
    """One HSP as a plus-strand-anchored row.

    Returns (q_start_plus, cells, inserts, s_first, s_step) where
    ``cells[i]`` is the subject character at plus-query position
    q_start_plus + i ('-' for a query-consuming gap) and ``inserts``
    maps a plus-query position p to subject bases inserted BEFORE p.
    """
    qa, _mid, sa = _expand_alignment(hsp, query, subject)
    minus = hsp.q_frame < 0
    if minus:
        qa = qa.translate(_COMP)[::-1]
        sa = sa.translate(_COMP)[::-1]
        q_start = qlen - hsp.q_end
        s_first = hsp.s_end        # 1-based descending
        s_step = -1
    else:
        q_start = hsp.q_off
        s_first = hsp.s_off + 1
        s_step = 1
    cells: list[str] = []
    inserts: dict[int, str] = {}
    qpos = q_start
    for qc, sc in zip(qa, sa):
        if qc == "-":              # subject insertion relative to query
            inserts[qpos] = inserts.get(qpos, "") + sc
        else:
            cells.append(sc)
            qpos += 1
    return q_start, cells, inserts, s_first, s_step


@dataclass
class AnchoredWriter:
    """outfmt 1 (anchored+identities), 2 (anchored), 3 (flat+ident),
    4 (flat)."""

    out: object
    show_identities: bool          # modes 1 / 3
    flat: bool                     # modes 3 / 4
    program: str = "BLASTN 2.2.28+ (gblastn-tpu)"
    dbname: str = ""
    db_num_seqs: int = 0
    db_length: int = 0
    line_length: int = LINE          # -line_length

    def write_header(self) -> None:
        self.out.write(f"{self.program}\n\n\n")
        self.out.write(f"Database: {self.dbname}\n")
        self.out.write(
            f"           {self.db_num_seqs:,} sequences; "
            f"{self.db_length:,} total letters\n\n"
        )

    def write_query_results(
        self,
        query_id: str,
        query_title: str,
        query_length: int,
        hits: list,   # [(sid, stitle, slen, [HSP], subject_blastna)]
        get_query,    # fn(context) -> context-local BLASTNA query
        kbp_gap,
        kbp_ungap,
        eff_searchsp: int,
    ) -> None:
        from gblastn_tpu_torch.io.encoding import BLASTNA_TO_IUPACNA

        o = self.out
        o.write(f"Query= {query_title}\n\n")
        o.write(f"Length={query_length}\n")
        if not hits:
            o.write("\n\n***** No hits found *****\n\n\n")
        else:
            o.write(
                "                                            "
                "          Score     E\n"
            )
            o.write(
                "Sequences producing significant alignments:"
                "          (Bits)  Value\n\n"
            )
            for sid, stitle, _slen, hsps, _subj in hits:
                best = hsps[0]
                desc = (sid + " " + stitle).strip()[:55]
                o.write(
                    f"  {desc:<55s}"
                    f"{bit_score_string(best.bit_score):>6s}  "
                    f"{evalue_string(best.evalue):>9s}\n"
                )
            o.write("\n")

            # master = plus-strand query (context 0 of this query)
            master = BLASTNA_TO_IUPACNA[
                np.asarray(get_query(0)[:query_length])
            ].tobytes().decode()

            rows = []
            for sid, _stitle, _slen, hsps, subject in hits:
                for hsp in hsps:
                    query = get_query(hsp.context)
                    q0, cells, ins, s_first, s_step = _hsp_row(
                        hsp, query, subject, query_length
                    )
                    rows.append((sid, q0, cells, ins, s_first, s_step))

            # column plan: (qpos, insert_slot) with insert columns
            # merged across rows in modes 1/2
            columns: list[tuple[int, int]] = []
            if not self.flat:
                widths: dict[int, int] = {}
                for _sid, _q0, _c, ins, _sf, _st in rows:
                    for p, s in ins.items():
                        widths[p] = max(widths.get(p, 0), len(s))
                for p in range(query_length):
                    for k in range(widths.get(p, 0)):
                        columns.append((p, k + 1))
                    columns.append((p, 0))
                for k in range(widths.get(query_length, 0)):
                    columns.append((query_length, k + 1))
            else:
                columns = [(p, 0) for p in range(query_length)]

            name_w = max(
                [len(query_id)] + [len(r[0]) for r in rows]
            )
            name_w = min(max(name_w, 7), 20)

            def emit_row(name, start, text, end) -> None:
                o.write(
                    f"{name[:name_w]:<{name_w}}  {start:<8d}"
                    f"{text}  {end}\n"
                )

            # render each row once over the full column list, with a
            # per-column subject-consumption count so block coordinate
            # labels are exact even at insert-column boundaries
            rendered = []
            for sid, q0, cells, ins, s_first, s_step in rows:
                row_end = q0 + len(cells)
                chars = []
                consumed = []
                for p, k in columns:
                    if k == 0:
                        use = 0
                        if self.flat and q0 < p <= row_end:
                            # hidden insertion before p still consumes
                            use += len(ins.get(p, ""))
                        if q0 <= p < row_end:
                            c = cells[p - q0]
                            if c != "-":
                                use += 1
                            if (
                                self.show_identities
                                and c == master[p]
                            ):
                                c = "."
                            chars.append(c)
                        else:
                            chars.append(" ")
                        consumed.append(use)
                    else:
                        s = ins.get(p, "")
                        if k <= len(s):
                            chars.append(s[k - 1])
                            consumed.append(1)
                        else:
                            chars.append(
                                "-" if q0 < p <= row_end else " "
                            )
                            consumed.append(0)
                rendered.append((sid, chars, consumed, s_first, s_step))

            L = self.line_length
            for b0 in range(0, len(columns), L):
                block = columns[b0: b0 + L]
                mtext = "".join(
                    master[p] if k == 0 else "-" for p, k in block
                )
                nq = sum(1 for _p, k in block if k == 0)
                q_start_1 = block[0][0] + 1
                emit_row(query_id, q_start_1, mtext,
                         block[0][0] + max(nq, 1))
                for sid, chars, consumed, s_first, s_step in rendered:
                    text = "".join(chars[b0: b0 + L])
                    if text.strip() == "":
                        continue
                    before = sum(consumed[:b0])
                    in_block = sum(consumed[b0: b0 + L])
                    s_start = s_first + s_step * before
                    s_end = (
                        s_start + s_step * (in_block - 1)
                        if in_block else s_start
                    )
                    emit_row(sid, s_start, text, s_end)
                o.write("\n")

        o.write("Lambda      K        H\n")
        o.write(
            f"   {kbp_ungap.Lambda:.3f}    {kbp_ungap.K:.3f}"
            f"    {kbp_ungap.H:.3f}\n\n"
        )
        o.write("Gapped\nLambda      K        H\n")
        o.write(
            f"   {kbp_gap.Lambda:.3f}    {kbp_gap.K:.3f}"
            f"    {kbp_gap.H:.3f}\n\n"
        )
        o.write(f"Effective search space used: {eff_searchsp}\n\n\n")

    def finalize(self) -> None:
        self.out.write(
            f"  Database: {self.dbname}\n"
            f"  Number of letters in database: {self.db_length:,}\n"
            f"  Number of sequences in database:  {self.db_num_seqs:,}\n\n"
        )
