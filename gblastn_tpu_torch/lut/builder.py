"""Nucleotide lookup-table builder (host side, NumPy).

TPU-shaped replacement for the reference lookup tables (reference:
NCBI c++/src/algo/blast/core/blast_nalookup.c). Where NCBI uses
three table kinds (SmallNa Int2 backbone+overflow :384, thick-backbone
NaLookup :554, megablast hashtable + next_pos linked chains :941), we use a
single **CSR direct-address table** for every width:

* ``counts_offsets``: int32[4^w + 1] -- prefix sums; ``offsets[x+1]-offsets[x]``
  is the number of query positions whose w-mer equals x (this subsumes the
  PV-presence-bit array: count==0 <=> PV bit clear);
* ``positions``: int32[n] -- query offsets (into the concatenated query
  block), ordered ascending within a word.

The linked-list chain layout of the reference pessimizes even GPUs (the
reference's own kernel walks hash chains one element at a time,
gpu_blastn_lookup_hash_kernel_v3.cuh:4-34); CSR turns seed resolution into
two gathers plus an indexed gather per slot, which XLA/Pallas vectorize.

Width selection and scan stride replicate ``BlastChooseNaLookupTable``
(blast_nalookup.c:51-140, including the reference's G-BLASTN modification
that forces width 11 for word_size 11 once >= 12000 entries) and
``scan_step = word_size - lut_word + 1`` (blast_nalookup.c:1095).

Indexed positions replicate ``BlastLookupIndexQueryExactMatches``
(blast_lookup.c:84) / ``s_FillContigMBTable`` (blast_nalookup.c:1105):
within every unmasked location of length >= word_size, every offset q such
that query[q : q+w] is ambiguity-free is indexed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BITS_PER_NUC = 2


@dataclass(frozen=True)
class LookupTable:
    word_size: int          # full word size W (e.g. 28 megablast, 11 blastn)
    lut_word_size: int      # indexed width w <= W
    scan_step: int          # subject scan stride = W - w + 1
    counts_offsets: np.ndarray   # int32[4^w + 1]
    positions: np.ndarray        # int32[total_positions]
    max_positions_per_word: int  # longest chain
    # word code per positions[i] (sorted ascending): lets the device
    # rebuild counts_offsets from an O(n_positions) upload instead of
    # shipping the dense 4^w+1 table (67MB at w=12) every batch
    position_words: np.ndarray | None = None
    # discontiguous megablast: window offsets of the template's used
    # bases (ascending; None = contiguous). word_size then holds the
    # template length (the diagonal/extension word span) and
    # lut_word_size the template weight (the index width).
    disc_offsets: tuple[int, ...] | None = None

    @property
    def table_size(self) -> int:
        return 1 << (BITS_PER_NUC * self.lut_word_size)

    @property
    def num_positions(self) -> int:
        return int(len(self.positions))


def choose_lut_width(word_size: int, approx_table_entries: int) -> int:
    """Replicates BlastChooseNaLookupTable's width choice
    (blast_nalookup.c:51-190, with the G-BLASTN word-11 modification)."""
    w = word_size
    n = approx_table_entries
    if w <= 6:
        return w
    if w == 7:
        return 6 if n < 250 else 7
    if w == 8:
        return 7 if n < 8500 else 8
    if w == 9:
        return 7 if n < 1250 else (8 if n < 21000 else 9)
    if w == 10:
        if n < 1250:
            return 7
        if n < 8500:
            return 8
        if n < 18000:
            return 9
        return 10
    if w == 11:
        # G-BLASTN (kyzhao 2013.7.23) forces width 11 above the SmallNa
        # cutoff rather than NCBI's 10/11 split.
        return 8 if n < 12000 else 11
    if w == 12:
        if n < 8500:
            return 8
        if n < 18000:
            return 9
        if n < 60000:
            return 10
        if n < 900000:
            return 11
        return 12
    # word size > 12 (megablast word 28 lands here)
    if n < 8500:
        return 8
    if n < 300000:
        return 11
    return 12


def _build_native(buf, locations, word_size, w, table_size):
    """native/lut.cpp fast path; None = fall back to NumPy."""
    from gblastn_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    locs = np.asarray(
        [c for ab in locations for c in ab], dtype=np.int64
    )
    offsets = np.zeros(table_size + 1, dtype=np.int32)
    pos_cap = max(len(buf), 1)
    positions = np.empty(pos_cap, dtype=np.int32)
    pos_words_buf = np.empty(pos_cap, dtype=np.int32)
    out = np.zeros(2, dtype=np.int64)
    bufc = np.ascontiguousarray(buf)
    r = lib.gblastn_lut_build(
        bufc.ctypes.data_as(ctypes.c_void_p), len(bufc),
        locs.ctypes.data_as(ctypes.c_void_p), len(locations),
        word_size, w,
        offsets.ctypes.data_as(ctypes.c_void_p),
        positions.ctypes.data_as(ctypes.c_void_p),
        pos_words_buf.ctypes.data_as(ctypes.c_void_p), pos_cap,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if r != 0:
        return None
    n = int(out[0])
    pos_words = pos_words_buf[:n].copy()
    return LookupTable(
        word_size=word_size,
        lut_word_size=w,
        scan_step=word_size - w + 1,
        counts_offsets=offsets,
        positions=positions[:n].copy(),
        max_positions_per_word=int(out[1]),
        position_words=pos_words,
    )


def build_lookup_table(
    query_buffer: np.ndarray,
    locations: list[tuple[int, int]],
    word_size: int,
    lut_word_size: int = 0,
    use_native: bool | None = None,
) -> LookupTable:
    """Build the CSR lookup table over the concatenated query block.

    ``locations`` are inclusive [from, to] unmasked ranges in the buffer
    (the complement of masked/sentinel regions). ``lut_word_size=0`` selects
    the width automatically from the approximate number of entries.
    """
    buf = np.asarray(query_buffer, dtype=np.uint8)
    approx_entries = sum(max(0, b - a + 1) for a, b in locations)
    w = lut_word_size or choose_lut_width(word_size, approx_entries)
    if w > word_size:
        raise ValueError("lut_word_size cannot exceed word_size")
    table_size = 1 << (BITS_PER_NUC * w)

    if use_native is not False:
        native = _build_native(buf, locations, word_size, w, table_size)
        if native is not None:
            return native

    # One whole-buffer pass instead of per-location slices: allowed
    # start positions come from a range-diff mask, word codes from w
    # shifted adds, word validity from one cumulative sum.
    n_starts = len(buf) - w + 1
    if n_starts > 0:
        delta = np.zeros(n_starts + 1, dtype=np.int32)
        for a, b in locations:
            # Locations shorter than the full word can never seed a hit
            # (blast_nalookup.c:1160, blast_lookup.c:103).
            if word_size > b - a + 1:
                continue
            hi = min(b - w + 2, n_starts)
            if hi > a:
                delta[a] += 1
                delta[hi] -= 1
        allowed = np.cumsum(delta[:-1]) > 0

        valid_base = buf < 4
        cum = np.concatenate([[0], np.cumsum(valid_base)])
        word_valid = (cum[w:] - cum[:-w]) == w

        codes = np.zeros(n_starts, dtype=np.int32)
        b32 = buf.astype(np.int32)
        for j in range(w):
            codes += b32[j: j + n_starts] << (2 * (w - 1 - j))

        sel = allowed & word_valid
        all_words = codes[sel]
        all_pos = np.flatnonzero(sel).astype(np.int32)
    else:
        all_words = np.zeros(0, dtype=np.int32)
        all_pos = np.zeros(0, dtype=np.int32)

    counts = np.bincount(all_words, minlength=table_size)
    offsets = np.zeros(table_size + 1, dtype=np.int32)
    np.cumsum(counts, dtype=np.int32, out=offsets[1:])
    # Order positions ascending within each word via a stable argsort
    # (int32 keys halve the radix passes).
    order = np.argsort(all_words, kind="stable")
    positions = all_pos[order]

    max_chain = int(counts.max()) if len(counts) and counts.max() else 0
    return LookupTable(
        word_size=word_size,
        lut_word_size=w,
        scan_step=word_size - w + 1,
        counts_offsets=offsets,
        positions=positions.astype(np.int32),
        max_positions_per_word=max_chain,
        position_words=all_words[order].astype(np.int32),
    )


def build_disc_lookup_table(
    query_buffer: np.ndarray,
    locations: list[tuple[int, int]],
    word_size: int,            # template weight: 11 or 12
    template_length: int,      # 16, 18 or 21
    template_type: str,        # "coding" | "optimal"
) -> LookupTable:
    """Discontiguous-megablast CSR table (s_FillDiscMBTable,
    blast_nalookup.c:663): within every unmasked location of length >=
    template_length, every window start whose FULL template window is
    ambiguity-free is indexed under its discontiguous word code.
    Scan stride is always 1 for discontiguous tables."""
    from gblastn_tpu_torch.lut.templates import disc_template_offsets

    offs = disc_template_offsets(word_size, template_length, template_type)
    w = len(offs)
    L = template_length
    table_size = 1 << (BITS_PER_NUC * w)
    buf = np.asarray(query_buffer, dtype=np.uint8)

    n_starts = len(buf) - L + 1
    if n_starts > 0:
        delta = np.zeros(n_starts + 1, dtype=np.int32)
        for a, b in locations:
            if L > b - a + 1:
                continue
            hi = min(b - L + 2, n_starts)
            if hi > a:
                delta[a] += 1
                delta[hi] -= 1
        allowed = np.cumsum(delta[:-1]) > 0

        valid_base = buf < 4
        cum = np.concatenate([[0], np.cumsum(valid_base)])
        window_valid = (cum[L:] - cum[:-L]) == L

        codes = np.zeros(n_starts, dtype=np.int32)
        b32 = buf.astype(np.int32)
        for r, j in enumerate(offs):
            codes += (b32[j: j + n_starts] & 3) << (2 * (w - 1 - r))

        sel = allowed & window_valid
        all_words = codes[sel]
        all_pos = np.flatnonzero(sel).astype(np.int32)
    else:
        all_words = np.zeros(0, dtype=np.int32)
        all_pos = np.zeros(0, dtype=np.int32)

    counts = np.bincount(all_words, minlength=table_size)
    offsets = np.zeros(table_size + 1, dtype=np.int32)
    np.cumsum(counts, dtype=np.int32, out=offsets[1:])
    order = np.argsort(all_words, kind="stable")
    max_chain = int(counts.max()) if len(counts) and counts.max() else 0
    return LookupTable(
        word_size=template_length,
        lut_word_size=w,
        scan_step=1,
        counts_offsets=offsets,
        positions=all_pos[order],
        max_positions_per_word=max_chain,
        position_words=all_words[order].astype(np.int32),
        disc_offsets=offs,
    )


def unmasked_locations(
    query_buffer: np.ndarray,
    context_offsets: np.ndarray,
    masks: list[list[tuple[int, int]]] | None = None,
) -> list[tuple[int, int]]:
    """Compute unmasked [from, to] locations per context.

    ``masks`` (optional) holds per-context lists of inclusive masked ranges
    in *buffer* coordinates (already offset). Sentinels between contexts
    bound the locations; the word-validity logic in the builder handles
    in-sequence ambiguity codes.
    """
    locations: list[tuple[int, int]] = []
    n_ctx = len(context_offsets) - 1
    for c in range(n_ctx):
        start = int(context_offsets[c])
        end = int(context_offsets[c + 1]) - 2  # exclusive sentinel
        if end < start:
            continue
        ranges = [(start, end)]
        if masks and masks[c]:
            for m0, m1 in sorted(masks[c]):
                new_ranges = []
                for r0, r1 in ranges:
                    if m1 < r0 or m0 > r1:
                        new_ranges.append((r0, r1))
                        continue
                    if r0 < m0:
                        new_ranges.append((r0, m0 - 1))
                    if m1 < r1:
                        new_ranges.append((m1 + 1, r1))
                ranges = new_ranges
        locations.extend(ranges)
    return locations
