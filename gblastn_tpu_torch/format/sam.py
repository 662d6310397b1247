"""SAM output writer (-outfmt 17).

Emits one SAM record per HSP: @HD/@SQ/@PG header, soft-clipped CIGAR
from the edit script, FLAG 16 + reverse-complemented SEQ for
minus-strand hits, and AS/NM/EV tags (alignment score, edit distance,
e-value). The role of blast_format.cpp's SAM path in newer toolkits;
emitted here natively from the HSP structures.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from gblastn_tpu_torch.format.tabular import calc_length_and_gaps
from gblastn_tpu_torch.hits import HSP, OP_DEL, OP_INS, OP_SUB
from gblastn_tpu_torch.io.encoding import BLASTNA_TO_IUPACNA


def cigar_string(hsp: HSP, query_length: int) -> str:
    """CIGAR with soft clips; M/I/D from the edit script. The clip
    lengths are in SEQ orientation (context-local), which is exactly
    how SAM defines them for reverse-strand records."""
    parts: list[str] = []
    if hsp.q_off > 0:
        parts.append(f"{hsp.q_off}S")
    script = hsp.edit_script or [(OP_SUB, hsp.q_end - hsp.q_off)]
    for op, num in script:
        if op == OP_SUB:
            parts.append(f"{num}M")
        elif op == OP_INS:
            parts.append(f"{num}I")
        else:
            parts.append(f"{num}D")
    tail = query_length - hsp.q_end
    if tail > 0:
        parts.append(f"{tail}S")
    return "".join(parts)


@dataclass
class SamWriter:
    out: object
    program: str = "gblastn-tpu"
    version: str = "0.1.0"
    references: list[tuple[str, int]] = field(default_factory=list)
    _header_written: bool = False

    def write_header(self) -> None:
        self.out.write("@HD\tVN:1.6\tSO:unsorted\n")
        for name, length in self.references:
            self.out.write(f"@SQ\tSN:{name}\tLN:{length}\n")
        self.out.write(
            f"@PG\tID:1\tPN:{self.program}\tVN:{self.version}\n"
        )
        self._header_written = True

    def write_hsp(
        self,
        hsp: HSP,
        query_id: str,
        subject_id: str,
        query_seq_context,   # np.ndarray BLASTNA codes of the context
        query_length: int,
    ) -> None:
        if not self._header_written:
            self.write_header()
        minus = hsp.q_frame < 0
        flag = 16 if minus else 0
        pos = hsp.s_off + 1
        cigar = cigar_string(hsp, query_length)
        seq = BLASTNA_TO_IUPACNA[query_seq_context].tobytes().decode()
        align_len, gaps, _ = calc_length_and_gaps(hsp)
        nm = align_len - hsp.num_ident  # mismatches + gap letters
        self.out.write(
            f"{query_id}\t{flag}\t{subject_id}\t{pos}\t255\t{cigar}\t"
            f"*\t0\t0\t{seq}\t*\t"
            f"AS:i:{hsp.score}\tNM:i:{nm}\tEV:f:{hsp.evalue:.2g}\n"
        )
