"""BLAST XML report (-outfmt 5).

Emits the NCBI_BlastOutput.dtd document structure produced by the
reference XML formatter (reference:
NCBI c++/src/algo/blast/format/blastxml_format.cpp and the
objects/blastxml ASN.1-generated serializers): one <Iteration> per
query, <Hit> per subject with <Hsp> children carrying scores,
coordinates (1-based; hit-from > hit-to with hit-frame -1 on the minus
strand), identities, and the aligned sequence/midline strings.
"""
from __future__ import annotations

from dataclasses import dataclass
from xml.sax.saxutils import escape

from gblastn_tpu_torch.format.pairwise import _expand_alignment
from gblastn_tpu_torch.format.tabular import calc_length_and_gaps, evalue_string
from gblastn_tpu_torch.hits import HSP


@dataclass
class XmlWriter:
    out: object
    program: str = "blastn"
    version: str = "BLASTN 2.2.28+ (gblastn-tpu)"
    dbname: str = ""
    params: dict | None = None
    _iteration: int = 0

    def write_prolog(self, first_query_id: str, first_query_def: str,
                     first_query_len: int) -> None:
        o = self.out
        o.write('<?xml version="1.0"?>\n')
        o.write(
            '<!DOCTYPE BlastOutput PUBLIC "-//NCBI//NCBI BlastOutput/EN" '
            '"http://www.ncbi.nlm.nih.gov/dtd/NCBI_BlastOutput.dtd">\n'
        )
        o.write("<BlastOutput>\n")
        o.write(
            f"  <BlastOutput_program>{self.program}</BlastOutput_program>\n"
        )
        o.write(
            f"  <BlastOutput_version>{escape(self.version)}"
            "</BlastOutput_version>\n"
        )
        o.write(
            "  <BlastOutput_reference>Zhang et al 2000, "
            "J Comput Biol 7(1-2):203-14</BlastOutput_reference>\n"
        )
        o.write(
            f"  <BlastOutput_db>{escape(self.dbname)}</BlastOutput_db>\n"
        )
        o.write(
            f"  <BlastOutput_query-ID>{escape(first_query_id)}"
            "</BlastOutput_query-ID>\n"
        )
        o.write(
            f"  <BlastOutput_query-def>{escape(first_query_def)}"
            "</BlastOutput_query-def>\n"
        )
        o.write(
            f"  <BlastOutput_query-len>{first_query_len}"
            "</BlastOutput_query-len>\n"
        )
        if self.params:
            o.write("  <BlastOutput_param>\n    <Parameters>\n")
            for tag, value in self.params.items():
                o.write(
                    f"      <Parameters_{tag}>{value}"
                    f"</Parameters_{tag}>\n"
                )
            o.write("    </Parameters>\n  </BlastOutput_param>\n")
        o.write("  <BlastOutput_iterations>\n")

    def write_iteration(
        self,
        query_id: str,
        query_def: str,
        query_len: int,
        hits,                   # [(sid, stitle, slen, [HSP], subject)]
        get_query,              # fn(context) -> context-local query codes
        eff_searchsp: int,
        kappa: float,
        lambda_: float,
        entropy: float,
    ) -> None:
        o = self.out
        self._iteration += 1
        o.write("    <Iteration>\n")
        o.write(
            f"      <Iteration_iter-num>{self._iteration}"
            "</Iteration_iter-num>\n"
        )
        o.write(
            f"      <Iteration_query-ID>{escape(query_id)}"
            "</Iteration_query-ID>\n"
        )
        o.write(
            f"      <Iteration_query-def>{escape(query_def)}"
            "</Iteration_query-def>\n"
        )
        o.write(
            f"      <Iteration_query-len>{query_len}"
            "</Iteration_query-len>\n"
        )
        o.write("      <Iteration_hits>\n")
        for hnum, (sid, stitle, slen, hsps, subject) in enumerate(hits, 1):
            o.write("        <Hit>\n")
            o.write(f"          <Hit_num>{hnum}</Hit_num>\n")
            o.write(f"          <Hit_id>{escape(sid)}</Hit_id>\n")
            o.write(
                f"          <Hit_def>{escape(stitle or sid)}</Hit_def>\n"
            )
            o.write(
                f"          <Hit_accession>{escape(sid)}"
                "</Hit_accession>\n"
            )
            o.write(f"          <Hit_len>{slen}</Hit_len>\n")
            o.write("          <Hit_hsps>\n")
            for num, hsp in enumerate(hsps, 1):
                o.write(self._hsp_xml(hsp, num, query_len, get_query,
                                      subject))
            o.write("          </Hit_hsps>\n        </Hit>\n")
        o.write("      </Iteration_hits>\n")
        o.write("      <Iteration_stat>\n        <Statistics>\n")
        o.write(
            f"          <Statistics_eff-space>{eff_searchsp}"
            "</Statistics_eff-space>\n"
        )
        o.write(
            f"          <Statistics_kappa>{kappa}</Statistics_kappa>\n"
        )
        o.write(
            f"          <Statistics_lambda>{lambda_}"
            "</Statistics_lambda>\n"
        )
        o.write(
            f"          <Statistics_entropy>{entropy}"
            "</Statistics_entropy>\n"
        )
        o.write("        </Statistics>\n      </Iteration_stat>\n")
        o.write("    </Iteration>\n")

    def _hsp_xml(self, hsp: HSP, num: int, query_len: int, get_query,
                 subject) -> str:
        align_len, gaps, _go = calc_length_and_gaps(hsp)
        query = get_query(hsp.context)
        qa, mid, sa = _expand_alignment(hsp, query, subject)
        if hsp.q_frame >= 0:
            qf, qt = hsp.q_off + 1, hsp.q_end
            hf, ht = hsp.s_off + 1, hsp.s_end
            hframe = 1
        else:
            qf, qt = query_len - hsp.q_end + 1, query_len - hsp.q_off
            hf, ht = hsp.s_end, hsp.s_off + 1
            hframe = -1
            comp = str.maketrans("ACGTRYMKWSBDHVN", "TGCAYRKMWSVHDBN")
            qa = qa.translate(comp)[::-1]
            sa = sa.translate(comp)[::-1]
            mid = mid[::-1]
        bits = f"{hsp.bit_score:.6g}"
        ev = evalue_string(hsp.evalue).strip()
        return (
            "            <Hsp>\n"
            f"              <Hsp_num>{num}</Hsp_num>\n"
            f"              <Hsp_bit-score>{bits}</Hsp_bit-score>\n"
            f"              <Hsp_score>{hsp.score}</Hsp_score>\n"
            f"              <Hsp_evalue>{ev}</Hsp_evalue>\n"
            f"              <Hsp_query-from>{qf}</Hsp_query-from>\n"
            f"              <Hsp_query-to>{qt}</Hsp_query-to>\n"
            f"              <Hsp_hit-from>{hf}</Hsp_hit-from>\n"
            f"              <Hsp_hit-to>{ht}</Hsp_hit-to>\n"
            f"              <Hsp_query-frame>1</Hsp_query-frame>\n"
            f"              <Hsp_hit-frame>{hframe}</Hsp_hit-frame>\n"
            f"              <Hsp_identity>{hsp.num_ident}</Hsp_identity>\n"
            f"              <Hsp_positive>{hsp.num_ident}</Hsp_positive>\n"
            f"              <Hsp_gaps>{gaps}</Hsp_gaps>\n"
            f"              <Hsp_align-len>{align_len}</Hsp_align-len>\n"
            f"              <Hsp_qseq>{qa}</Hsp_qseq>\n"
            f"              <Hsp_hseq>{sa}</Hsp_hseq>\n"
            f"              <Hsp_midline>{mid}</Hsp_midline>\n"
            "            </Hsp>\n"
        )

    def finalize(self) -> None:
        self.out.write("  </BlastOutput_iterations>\n</BlastOutput>\n")
