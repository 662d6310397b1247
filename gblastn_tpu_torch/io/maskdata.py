"""Mask-data interchange files (makedb -mask_data / convert2blastmask).

The interchange format is the maskers' interval output (what our
dustmasker/windowmasker subcommands and NCBI's ``-outfmt interval``
print): a FASTA-style ``>id [title]`` header followed by one
``start - end`` line per masked range, coordinates 0-based INCLUSIVE.
Plays the role of the reference's maskinfo ASN.1 files consumed by
makeblastdb -mask_data (reference:
src/objtools/seqmasks_io/mask_writer_int.cpp (writer) and
src/objtools/blast/seqdb_writer/build_db.cpp (reader path)).
"""
from __future__ import annotations

from pathlib import Path


def read_interval_masks(path) -> dict[str, list[tuple[int, int]]]:
    """id -> sorted half-open (start, end) intervals."""
    masks: dict[str, list[tuple[int, int]]] = {}
    current: list[tuple[int, int]] | None = None
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            sid = line[1:].split()[0]
            current = masks.setdefault(sid, [])
        else:
            if current is None:
                raise ValueError(
                    f"{path}: interval line before any '>' header"
                )
            a, _, b = line.partition("-")
            current.append((int(a), int(b) + 1))
    for ivs in masks.values():
        ivs.sort()
    return masks


def write_interval_masks(
    out, masks: dict[str, list[tuple[int, int]]]
) -> None:
    """Inverse of read_interval_masks (half-open in, inclusive out)."""
    for sid, ivs in masks.items():
        out.write(f">{sid}\n")
        for a, b in ivs:
            out.write(f"{a} - {b - 1}\n")


def lowercase_halfopen(seq) -> list[tuple[int, int]]:
    """Half-open runs of lowercase letters (the convert2blastmask
    extraction, reference src/app/blastdb/convert2blastmask.cpp)."""
    from gblastn_tpu_torch.masking.lcase import lowercase_intervals

    return [(a, b + 1) for a, b in lowercase_intervals(seq)]
