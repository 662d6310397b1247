"""Discontiguous-megablast word templates.

The twelve NCBI templates (11 or 12 of 16/18/21, coding or optimal) as
data: the bit-extraction mask/shift groups are transcribed verbatim from
the reference index functions (reference:
NCBI c++/include/algo/blast/core/
blast_nalookup.h:302-520, ``DiscontigIndex_<w>_<len>_<type>``), then
reduced to the list of used base offsets within the template window.

Reduction rule: the reference accumulates the last ``length`` bases with
the newest base in the low-order bit pair, then packs the masked bit
groups tightly and monotonically into a ``2*weight``-bit index (asserted
below for all twelve).  Tight monotone packing means the index equals
the plain concatenation of the selected bases' 2-bit codes, oldest base
most significant.  In window-start coordinates (offset j, 0-based from
the left end of the template window), the selected offsets are
``j = length - 1 - k`` for each masked bit pair ``k``; computing
``sum(base[start + j] << 2*(weight-1-rank(j)))`` over ascending ``j``
therefore reproduces ``ComputeDiscontiguousIndex`` exactly.
"""
from __future__ import annotations

# (mask, shift) groups over the 64-bit accumulator; shift > 0 with
# "lo" semantics means >> shift, entries tagged "hi" operate on
# (accum >> 32) with << shift. Transcribed from blast_nalookup.h.
_GROUPS: dict[tuple[int, int, str], list[tuple[str, int, int]]] = {
    (11, 16, "coding"): [
        ("lo", 0x00000003, 0), ("lo", 0x000000F0, -2),
        ("lo", 0x00003C00, -4), ("lo", 0x000F0000, -6),
        ("lo", 0x03C00000, -8), ("lo", 0xF0000000, -10),
    ],
    (11, 16, "optimal"): [
        ("lo", 0x0000003F, 0), ("lo", 0x00000F00, -2),
        ("lo", 0x0003C000, -4), ("lo", 0x00300000, -6),
        ("lo", 0xFC000000, -10),
    ],
    (11, 18, "coding"): [
        ("lo", 0x00000003, 0), ("lo", 0x000000F0, -2),
        ("lo", 0x00003C00, -4), ("lo", 0x00030000, -6),
        ("lo", 0x03C00000, -10), ("lo", 0xF0000000, -12),
        ("hi", 0x0000000C, 18),
    ],
    (11, 18, "optimal"): [
        ("lo", 0x0000003F, 0), ("lo", 0x00000300, -2),
        ("lo", 0x0003C000, -6), ("lo", 0x00300000, -8),
        ("lo", 0x0C000000, -12), ("lo", 0xC0000000, -14),
        ("hi", 0x0000000F, 18),
    ],
    (11, 21, "coding"): [
        ("lo", 0x00000003, 0), ("lo", 0x000000F0, -2),
        ("lo", 0x00000C00, -4), ("lo", 0x000F0000, -8),
        ("lo", 0x00C00000, -10), ("lo", 0xF0000000, -14),
        ("hi", 0x0000000C, 16), ("hi", 0x00000300, 12),
    ],
    (11, 21, "optimal"): [
        ("lo", 0x0000003F, 0), ("lo", 0x00000300, -2),
        ("lo", 0x0000C000, -6), ("lo", 0x00C00000, -12),
        ("lo", 0x0C000000, -14), ("hi", 0x00000003, 14),
        ("hi", 0x000003F0, 12),
    ],
    (12, 16, "coding"): [
        ("lo", 0x00000003, 0), ("lo", 0x000000F0, -2),
        ("lo", 0x00003C00, -4), ("lo", 0x000F0000, -6),
        ("lo", 0xFFC00000, -8),
    ],
    (12, 16, "optimal"): [
        ("lo", 0x0000003F, 0), ("lo", 0x00000F00, -2),
        ("lo", 0x0003C000, -4), ("lo", 0x00F00000, -6),
        ("lo", 0xFC000000, -8),
    ],
    (12, 18, "coding"): [
        ("lo", 0x00000003, 0), ("lo", 0x000000F0, -2),
        ("lo", 0x00003C00, -4), ("lo", 0x000F0000, -6),
        ("lo", 0x03C00000, -8), ("lo", 0xF0000000, -10),
        ("hi", 0x0000000C, 20),
    ],
    (12, 18, "optimal"): [
        ("lo", 0x0000003F, 0), ("lo", 0x00000F00, -2),
        ("lo", 0x0000C000, -4), ("lo", 0x00F00000, -8),
        ("lo", 0x0C000000, -10), ("lo", 0xC0000000, -12),
        ("hi", 0x0000000F, 20),
    ],
    (12, 21, "coding"): [
        ("lo", 0x00000003, 0), ("lo", 0x000000F0, -2),
        ("lo", 0x00000C00, -4), ("lo", 0x000F0000, -8),
        ("lo", 0x03C00000, -10), ("lo", 0xF0000000, -12),
        ("hi", 0x0000000C, 18), ("hi", 0x00000300, 14),
    ],
    (12, 21, "optimal"): [
        ("lo", 0x0000003F, 0), ("lo", 0x00000300, -2),
        ("lo", 0x0000C000, -6), ("lo", 0x00F00000, -10),
        ("lo", 0x0C000000, -12), ("hi", 0x00000003, 16),
        ("hi", 0x000003F0, 14),
    ],
}


def _derive_offsets(weight: int, length: int, kind: str) -> tuple[int, ...]:
    """Used window offsets (ascending, 0 = left end of the template
    window), with the tight-monotone-packing property asserted."""
    groups = _GROUPS[(weight, length, kind)]
    covered = []          # (out_lo, out_hi, k_pairs)
    ks: list[int] = []
    for where, mask, shift in groups:
        base = 32 if where == "hi" else 0
        bits = [b for b in range(32) if (mask >> b) & 1]
        assert bits == list(range(bits[0], bits[-1] + 1)), "mask not a run"
        out_lo = bits[0] + shift
        out_hi = bits[-1] + shift
        covered.append((out_lo, out_hi))
        for b in range(bits[0], bits[-1] + 1, 2):
            ks.append((base + b) // 2)
    # tight monotone packing over [0, 2*weight)
    covered.sort()
    pos = 0
    for lo, hi in covered:
        assert lo == pos, (weight, length, kind, covered)
        pos = hi + 1
    assert pos == 2 * weight, (weight, length, kind, pos)
    ks_sorted = sorted(ks)
    assert ks == ks_sorted and len(ks) == weight, (weight, length, kind)
    # accumulator k (0 = newest base) -> window offset j = length-1-k
    offsets = tuple(sorted(length - 1 - k for k in ks))
    assert offsets[0] == 0 and offsets[-1] == length - 1
    return offsets


DISC_TEMPLATES: dict[tuple[int, int, str], tuple[int, ...]] = {
    key: _derive_offsets(*key) for key in _GROUPS
}

TEMPLATE_TYPES = ("coding", "optimal", "coding_and_optimal")


def disc_template_offsets(
    word_size: int, template_length: int, template_type: str
) -> tuple[int, ...]:
    """Window offsets for one template (s_GetDiscTemplateType analog,
    blast_nalookup.c:609). ``coding_and_optimal`` callers take the
    coding offsets here and the optimal ones separately."""
    kind = "coding" if template_type == "coding_and_optimal" else (
        template_type
    )
    key = (word_size, template_length, kind)
    if key not in DISC_TEMPLATES:
        raise ValueError(
            f"unsupported discontiguous template: word {word_size}, "
            f"length {template_length}, type {template_type!r}"
        )
    return DISC_TEMPLATES[key]


def compute_disc_index(accum: int, word_size: int, template_length: int,
                       template_type: str) -> int:
    """ComputeDiscontiguousIndex (blast_nalookup.h:535) oracle: index
    from an accumulator holding the last ``template_length`` bases,
    newest in the low bit pair. Used by tests."""
    offs = disc_template_offsets(word_size, template_length, template_type)
    w = len(offs)
    idx = 0
    for r, j in enumerate(offs):
        k = template_length - 1 - j
        base = (accum >> (2 * k)) & 3
        idx |= base << (2 * (w - 1 - r))
    return idx
