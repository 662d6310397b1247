"""Nucleotide alphabets and bit-packed encodings.

TPU-native reimplementation of the encoding conventions used by NCBI BLAST
(reference: NCBI c++/src/algo/blast/core/blast_encoding.c:61-130).

Alphabets
---------
* BLASTNA  -- 16-letter alphabet used for unpacked query sequence:
              A=0 C=1 G=2 T=3, then 11 IUPAC ambiguity codes, 15 = gap
              sentinel placed between query contexts.
* NCBI2NA  -- 2-bit alphabet A=0 C=1 G=2 T=3, packed 4 bases/byte with the
              first base in the two *most significant* bits of the byte
              (matching the on-disk .nsq layout of BLAST databases).

The engine keeps subjects 2-bit packed (ambiguous bases are randomized like
makeblastdb does, with an ambiguity mask kept on the side) and queries in
BLASTNA so that seeds hitting ambiguity codes score correctly.
"""
from __future__ import annotations

import numpy as np

BLASTNA_SIZE = 16

BLASTNA_TO_IUPACNA = np.frombuffer(b"ACGTRYMKWSBDHVN-", dtype=np.uint8)

# blast_encoding.c:61-78
BLASTNA_TO_NCBI4NA = np.array(
    [1, 2, 4, 8, 5, 10, 3, 12, 9, 6, 14, 13, 11, 7, 15, 0], dtype=np.uint8
)

NCBI4NA_TO_BLASTNA = np.zeros(16, dtype=np.uint8)
for _b, _n in enumerate(BLASTNA_TO_NCBI4NA):
    NCBI4NA_TO_BLASTNA[_n] = _b

# IUPACNA (ASCII) -> BLASTNA, case-insensitive; everything unknown maps to N.
IUPACNA_TO_BLASTNA = np.full(256, 14, dtype=np.uint8)
for _i, _ch in enumerate(BLASTNA_TO_IUPACNA):
    IUPACNA_TO_BLASTNA[_ch] = _i
    if chr(_ch).isalpha():
        IUPACNA_TO_BLASTNA[_ch + 32] = _i  # lowercase
IUPACNA_TO_BLASTNA[ord("U")] = 3  # RNA
IUPACNA_TO_BLASTNA[ord("u")] = 3

# Complement in BLASTNA space (A<->T, C<->G, and the IUPAC codes' complements).
# Complement of a 4na code x is bit-reverse of its 4 bits.
_COMPL_4NA = np.array(
    [((n & 1) << 3) | ((n & 2) << 1) | ((n & 4) >> 1) | ((n & 8) >> 3) for n in range(16)],
    dtype=np.uint8,
)
BLASTNA_COMPLEMENT = NCBI4NA_TO_BLASTNA[_COMPL_4NA[BLASTNA_TO_NCBI4NA]]


def seq_to_blastna(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII IUPAC sequence -> BLASTNA codes (uint8)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    arr = np.frombuffer(bytes(seq), dtype=np.uint8) if not isinstance(seq, np.ndarray) else seq
    return IUPACNA_TO_BLASTNA[arr]


def blastna_to_seq(codes: np.ndarray) -> str:
    return BLASTNA_TO_IUPACNA[codes].tobytes().decode("ascii")


def reverse_complement_blastna(codes: np.ndarray) -> np.ndarray:
    return BLASTNA_COMPLEMENT[codes[::-1]]


def blastna_to_2na(codes: np.ndarray, seed: int = 0x5AD) -> tuple[np.ndarray, np.ndarray]:
    """Map BLASTNA codes to 2-bit codes.

    Ambiguity codes are replaced by a deterministic pseudo-random choice among
    their constituent bases (the role of makeblastdb's ambiguity randomization)
    and reported in the returned boolean ambiguity mask.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    ambig = codes >= 4
    out = np.where(ambig, 0, codes).astype(np.uint8)
    if ambig.any():
        rng = np.random.default_rng(seed)
        idx = np.nonzero(ambig)[0]
        for i in idx:
            na4 = BLASTNA_TO_NCBI4NA[codes[i]]
            # NCBI4NA bit order: A=1(bit0), C=2, G=4, T=8 -> base b has bit (1<<b)
            choices = [b for b in range(4) if na4 & (1 << b)] or [0]
            out[i] = choices[int(rng.integers(len(choices)))]
    return out, ambig


def pack_2na(codes2: np.ndarray) -> np.ndarray:
    """2-bit codes -> packed bytes, 4 bases/byte, first base in high bits.

    Length is padded with zeros (A) to a multiple of 4.
    """
    codes2 = np.asarray(codes2, dtype=np.uint8)
    n = len(codes2)
    pad = (-n) % 4
    if pad:
        codes2 = np.concatenate([codes2, np.zeros(pad, dtype=np.uint8)])
    c = codes2.reshape(-1, 4)
    return (
        (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
    ).astype(np.uint8)


def unpack_2na(packed: np.ndarray, length: int) -> np.ndarray:
    """Packed bytes -> 2-bit codes (uint8), truncated to `length`."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty((len(packed), 4), dtype=np.uint8)
    out[:, 0] = (packed >> 6) & 3
    out[:, 1] = (packed >> 4) & 3
    out[:, 2] = (packed >> 2) & 3
    out[:, 3] = packed & 3
    return out.reshape(-1)[:length]
