"""Pairwise alignment report (-outfmt 0), blastn's default display.

Follows the structure of the reference report renderer (reference:
NCBI c++/src/objtools/align_format/showalign.cpp
CDisplaySeqalign and src/algo/blast/format/blast_format.cpp
PrintOneResultSet): program banner, per-query header, one-line
descriptions table, per-subject sections with per-HSP score/identity/
strand lines and 60-column alignment blocks, and the closing statistics
block (Karlin-Altschul parameters, effective search space).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gblastn_tpu_torch.format.tabular import (
    percent_match,
    bit_score_string,
    calc_length_and_gaps,
    evalue_string,
)
from gblastn_tpu_torch.hits import HSP, OP_DEL, OP_INS, OP_SUB
from gblastn_tpu_torch.io.encoding import BLASTNA_TO_IUPACNA

LINE = 60


def _expand_alignment(
    hsp: HSP, query: np.ndarray, subject: np.ndarray
) -> tuple[str, str, str]:
    """Aligned query/midline/subject strings over the edit script."""
    q_parts: list[str] = []
    s_parts: list[str] = []
    mid: list[str] = []
    qi, si = hsp.q_off, hsp.s_off
    script = hsp.edit_script or [(OP_SUB, hsp.q_end - hsp.q_off)]
    for op, num in script:
        if op == OP_SUB:
            qs = BLASTNA_TO_IUPACNA[query[qi: qi + num]].tobytes().decode()
            ss = BLASTNA_TO_IUPACNA[
                subject[si: si + num]
            ].tobytes().decode()
            q_parts.append(qs)
            s_parts.append(ss)
            mid.append(
                "".join("|" if a == b else " " for a, b in zip(qs, ss))
            )
            qi += num
            si += num
        elif op == OP_DEL:
            ss = BLASTNA_TO_IUPACNA[
                subject[si: si + num]
            ].tobytes().decode()
            q_parts.append("-" * num)
            s_parts.append(ss)
            mid.append(" " * num)
            si += num
        else:
            qs = BLASTNA_TO_IUPACNA[query[qi: qi + num]].tobytes().decode()
            q_parts.append(qs)
            s_parts.append("-" * num)
            mid.append(" " * num)
            qi += num
    return "".join(q_parts), "".join(mid), "".join(s_parts)


@dataclass
class PairwiseWriter:
    out: object
    program: str = "BLASTN 2.2.28+ (gblastn-tpu)"
    dbname: str = ""
    db_num_seqs: int = 0
    db_length: int = 0
    line_length: int = LINE          # -line_length
    num_descriptions: int = 500      # -num_descriptions (summary rows)

    def write_header(self) -> None:
        self.out.write(f"{self.program}\n\n\n")
        self.out.write(
            "Reference: Zheng Zhang, Scott Schwartz, Lukas Wagner, and\n"
            "Webb Miller (2000), \"A greedy algorithm for aligning DNA\n"
            "sequences\", J Comput Biol 2000; 7(1-2):203-14.\n\n\n"
        )
        self.out.write(f"Database: {self.dbname}\n")
        self.out.write(
            f"           {self.db_num_seqs:,} sequences; "
            f"{self.db_length:,} total letters\n\n"
        )

    def write_query_results(
        self,
        query_title: str,
        query_length: int,
        hits: list,   # [(subject_id, subject_title, slen, [HSP]),...]
        get_query,    # fn(context) -> np.ndarray context-local query
        get_subject,  # fn() per hit -> np.ndarray BLASTNA subject
        kbp_gap,
        kbp_ungap,
        eff_searchsp: int,
    ) -> None:
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
            for sid, stitle, _slen, hsps, _subj in (
                hits[: self.num_descriptions]
            ):
                best = hsps[0]
                desc = (sid + " " + stitle).strip()[:55]
                o.write(
                    f"  {desc:<55s}"
                    f"{bit_score_string(best.bit_score):>6s}  "
                    f"{evalue_string(best.evalue).strip()}\n"
                )
            o.write("\n\n")

            for sid, stitle, slen, hsps, subject in hits:
                title = (sid + " " + stitle).strip()
                o.write(f"> {title}\nLength={slen}\n\n")
                for hsp in hsps:
                    align_len, gaps, _go = calc_length_and_gaps(hsp)
                    ident = hsp.num_ident
                    pid = percent_match(ident, align_len)
                    pgap = percent_match(gaps, align_len)
                    # bit_score_buf keeps its %4.0lf-style padding in
                    # the reference stream (" Score =  503 bits"),
                    # showalign.cpp:3547
                    o.write(
                        f" Score = {bit_score_string(hsp.bit_score)}"
                        f" bits ({hsp.score}),  "
                        f"Expect = {evalue_string(hsp.evalue).strip()}\n"
                    )
                    o.write(
                        f" Identities = {ident}/{align_len} ({pid}%),"
                        f" Gaps = {gaps}/{align_len} ({pgap}%)\n"
                    )
                    minus = hsp.q_frame < 0
                    o.write(
                        f" Strand=Plus/{'Minus' if minus else 'Plus'}\n\n"
                    )

                    query = get_query(hsp.context)
                    qa, mid, sa = _expand_alignment(hsp, query, subject)
                    if minus:
                        # blastn shows minus hits as query-plus /
                        # subject-minus: reverse-complement the display
                        comp = str.maketrans("ACGTRYMKWSBDHVN",
                                             "TGCAYRKMWSVHDBN")
                        qa = qa.translate(comp)[::-1]
                        sa = sa.translate(comp)[::-1]
                        mid = mid[::-1]
                        q_pos = query_length - hsp.q_end + 1
                        s_pos = hsp.s_end
                        s_step = -1
                    else:
                        q_pos = hsp.q_off + 1
                        s_pos = hsp.s_off + 1
                        s_step = 1
                    L = self.line_length
                    for i in range(0, len(qa), L):
                        qs = qa[i: i + L]
                        ms = mid[i: i + L]
                        ss = sa[i: i + L]
                        nq = sum(1 for c in qs if c != "-")
                        ns = sum(1 for c in ss if c != "-")
                        q_end = q_pos + nq - 1 if nq else q_pos
                        s_end = s_pos + s_step * (ns - 1) if ns else s_pos
                        o.write(f"Query  {q_pos:<7d}{qs}  {q_end}\n")
                        o.write(f"       {'':7s}{ms}\n")
                        o.write(f"Sbjct  {s_pos:<7d}{ss}  {s_end}\n\n")
                        if nq:
                            q_pos = q_end + 1
                        if ns:
                            s_pos = s_end + s_step
                o.write("\n")

        o.write(f"Lambda      K        H\n")
        o.write(
            f"   {kbp_ungap.Lambda:.3f}    {kbp_ungap.K:.3f}"
            f"    {kbp_ungap.H:.3f}\n\n"
        )
        o.write(f"Gapped\nLambda      K        H\n")
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
