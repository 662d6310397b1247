"""Device seeding stage in PyTorch: subject scan, seed resolution and
mini-extension.

The port's counterpart of the parts of ``gblastn_tpu/ops/seeding.py`` on
the megablast main path (reference: NCBI blast_nascan.c scanners and
na_ungapped.c:1026 ``s_BlastNaExtend``). Shapes are exact: every function
returns only real seeds, in the JAX package's lane order (scan position
ascending, then CSR slot, then mini-extension survivors in order; the
indexed scan's query position, then index slot), so the final stable
score sort sees the same pre-order. Coordinates are int64, and the scan
and the resident build go by chunks of bounded size, so a subject of any
length the card holds is scanned in one call.

Packed words are held as int64 (values < 2^32): shifts of int32 are
arithmetic and torch.uint32 supports few operators.
"""
from __future__ import annotations

import numpy as np
import torch

from gblastn_tpu_torch.io.encoding import BLASTNA_TO_NCBI4NA


BUILD_CHUNK = 1 << 26   # packed bytes (or bases) a step of the resident build


def unpack_2na(packed: torch.Tensor) -> torch.Tensor:
    """uint8 packed (4 bases/byte, first base in the high bits) -> int8
    codes, BUILD_CHUNK packed bytes a step (the transients stay a few
    times that, whatever the database's size)."""
    n = packed.shape[0]
    out = torch.empty(4 * n, dtype=torch.int8, device=packed.device)
    for a in range(0, n, BUILD_CHUNK):
        p = packed[a: a + BUILD_CHUNK]
        cols = torch.stack([(p >> 6) & 3, (p >> 4) & 3, (p >> 2) & 3,
                            p & 3], dim=-1)
        out[4 * a: 4 * (a + p.shape[0])] = cols.reshape(-1).view(torch.int8)
    return out


def valid_from_intervals(S: int, starts: torch.Tensor,
                         ends: torch.Tensor) -> torch.Tensor:
    """bool[S] validity mask from per-subject [start, end) intervals: a
    position is valid where more intervals have started than ended at it
    (bounds clamped to [0, S]). BUILD_CHUNK positions a step, each from
    the count at its first position and the bounds inside it, in int32."""
    dev = starts.device
    st = starts.long().clamp(0, S)
    en = ends.long().clamp(0, S)
    out = torch.empty(S, dtype=torch.bool, device=dev)
    for a in range(0, S, BUILD_CHUNK):
        b = min(a + BUILD_CHUNK, S)
        d = torch.zeros(b - a, dtype=torch.int32, device=dev)
        d[0] = ((st <= a).sum() - (en <= a).sum()).to(torch.int32)
        for bound, sign in ((st, 1), (en, -1)):
            inside = bound[(bound > a) & (bound < b)] - a
            d.index_add_(0, inside, torch.full_like(inside, sign,
                                                    dtype=torch.int32))
        out[a:b] = torch.cumsum(d, dim=0, dtype=torch.int32) > 0
    return out


def pack_subject_words(packed: torch.Tensor) -> torch.Tensor:
    """uint8[S/4] packed bytes -> int64[ceil(S/16)] words of 16 bases,
    first base in the highest 2 bits of the low 32 (the gather unit of
    mini_extend_packed). Byte counts not a multiple of 4 are zero-padded
    to the word. BUILD_CHUNK bytes a step."""
    pad = (-packed.shape[0]) % 4
    if pad:
        packed = torch.cat([packed, packed.new_zeros(pad)])
    words = packed.view(-1, 4)
    out = torch.empty(words.shape[0], dtype=torch.int64,
                      device=packed.device)
    step = max(BUILD_CHUNK // 4, 1)
    for a in range(0, words.shape[0], step):
        b = words[a: a + step].to(torch.int64)
        out[a: a + b.shape[0]] = ((b[:, 0] << 24) | (b[:, 1] << 16)
                                  | (b[:, 2] << 8) | b[:, 3])
    return out


def pack_query_nibbles(query: torch.Tensor) -> torch.Tensor:
    """uint8[Q] BLASTNA codes (Q % 8 == 0) -> int64[Q/8] of NCBI4na
    mask nibbles (A=1 C=2 G=4 T=8, ambiguity = member bitmask, sentinel
    0), 8 codes per word, first code in the highest 4 bits."""
    mask4 = torch.from_numpy(BLASTNA_TO_NCBI4NA.astype(np.int64)).to(
        query.device
    )
    q = mask4[query.long()].view(-1, 8)
    w = torch.zeros(q.shape[0], dtype=torch.int64, device=query.device)
    for k in range(8):
        w |= q[:, k] << (4 * (7 - k))
    return w


def presence_table(lut_offsets):
    """The table ``_presence_hits`` probes: the bit-packed presence
    vector (int64 words of 32 bits; the PV texture of the reference GPU
    scan, gpu_blastn_mb_scan_kernel_v3.cuh:26), so the random probes
    touch a table 32x smaller than the offsets, or for a small table the
    bool presence of each word."""
    table_size = lut_offsets.shape[0] - 1
    present = lut_offsets[1:] > lut_offsets[:-1]
    if table_size % 32 or table_size < 4096:
        return present
    bits = present.view(table_size // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits << shifts).sum(dim=1)


def _presence_hits(words, valid_word, lut_offsets, table=None):
    """Scan positions whose word has a CSR chain, probed in
    ``presence_table(lut_offsets)`` (built here unless ``table`` is
    given)."""
    if table is None:
        table = presence_table(lut_offsets)
    if table.dtype == torch.bool:
        return valid_word & table[words]
    return valid_word & (((table[words >> 5] >> (words & 31)) & 1) == 1)


def scan_span(lut_word: int, disc_offsets=None) -> int:
    """The bases a scan word reads: ``lut_word`` consecutive ones, or a
    discontiguous template's whole window."""
    return disc_offsets[-1] + 1 if disc_offsets else lut_word


SCAN_CHUNK = 1 << 24    # scan positions a step of scan_block
MINI_CHUNK = 1 << 21    # raw seeds a step of the mini-extension


def masked_words(pos, span: int, mask_starts, mask_ends):
    """bool: whether the word of ``span`` bases at each subject position
    ``pos`` overlaps a database mask interval (``mask_starts`` /
    ``mask_ends``: int64 sorted, non-overlapping, half-open). The first
    interval ending after the position is the only one that can: it
    overlaps where it starts before the word's end."""
    j = torch.searchsorted(mask_ends, pos, right=True).clamp_(
        max=mask_ends.shape[0] - 1)
    return (mask_starts[j] < pos + span) & (mask_ends[j] > pos)


def _fan_out(pos, start, count, table):
    """CSR fan-out: for each entry i, ``count[i]`` seeds carrying
    ``pos[i]`` and ``table[start[i] + slot]``, slot ascending, entries in
    order. Returns (repeated pos, int64 table values)."""
    first = torch.cumsum(count, dim=0) - count
    slot = (torch.arange(int(count.sum()), device=pos.device)
            - torch.repeat_interleave(first, count))
    vals = table[torch.repeat_interleave(start, count) + slot]
    return torch.repeat_interleave(pos, count), vals.to(torch.int64)


def _scan_positions(subject2, subject_valid, lut_offsets, lut_positions,
                    presence, k0: int, k1: int, scan_step: int,
                    lut_word: int, disc_offsets, mask_starts, mask_ends,
                    first: int = 0):
    """``scan_block`` over the scan positions k0 <= k < k1, with the
    table's ``presence_table``."""
    dev = subject2.device
    offs = tuple(disc_offsets) if disc_offsets else tuple(range(lut_word))
    w = len(offs)
    span = scan_span(lut_word, disc_offsets)
    pos = torch.arange(k0, k1, dtype=torch.int64, device=dev) * scan_step
    if first:
        pos += first
    words = torch.zeros(k1 - k0, dtype=torch.int64, device=dev)
    valid_word = torch.ones(k1 - k0, dtype=torch.bool, device=dev)
    for r, j in enumerate(offs):
        words += subject2[pos + j].to(torch.int64) << (2 * (w - 1 - r))
    for j in range(span):
        valid_word &= subject_valid[pos + j]
    if mask_starts is not None and mask_starts.numel():
        valid_word &= ~masked_words(pos, span, mask_starts, mask_ends)
    words = torch.where(valid_word, words, 0)
    hit = _presence_hits(words, valid_word, lut_offsets, presence)
    hidx = torch.nonzero(hit).squeeze(1)
    w_h = words[hidx]
    start = lut_offsets[w_h].to(torch.int64)
    count = lut_offsets[w_h + 1].to(torch.int64) - start
    s_off, q_off = _fan_out(pos[hidx], start, count, lut_positions)
    return q_off, s_off


def scan_block(subject2, subject_valid, lut_offsets, lut_positions, *,
               scan_step: int, lut_word: int, n_scan: int,
               disc_offsets=None, mask_starts=None, mask_ends=None,
               chunk: int = SCAN_CHUNK, first: int = 0):
    """Scan the subject at stride positions and resolve CSR seeds.

    Word codes are taken at positions ``first + k * scan_step`` (k <
    n_scan; a streamed block starts at its halo, so that its positions
    keep the global stride phase) from
    ``lut_word`` consecutive valid bases, or with ``disc_offsets`` (a
    discontiguous template) from the bases at those offsets of a window
    that must be valid throughout (s_FillDiscMBTable resets on any
    ambiguity, blast_nalookup.c:757); positions whose word has a chain
    fan out to every query offset of the chain. With ``mask_starts`` /
    ``mask_ends`` (the database soft-mask intervals, int64 sorted and
    non-overlapping) a word that overlaps an interval is not seeded
    (masksubj.inl s_DetermineScanningOffsets); extensions still run
    through masked bases. ``chunk`` scan positions a step, whose seeds are
    concatenated in position order, so the transients stay bounded
    however long the subject is. Returns int64 (q_off, s_off), ordered by
    scan position, then chain slot."""
    presence = presence_table(lut_offsets)
    parts = [_scan_positions(subject2, subject_valid, lut_offsets,
                             lut_positions, presence, k0,
                             min(k0 + chunk, n_scan), scan_step, lut_word,
                             disc_offsets, mask_starts, mask_ends, first)
             for k0 in range(0, max(n_scan, 1), chunk)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(c) for c in zip(*parts))


def indexed_scan_block(query, q_allowed, idx_offsets, idx_positions, *,
                       lut_word: int, mask_starts=None, mask_ends=None):
    """Indexed megablast's scan, the role-swapped twin of ``scan_block``:
    every allowed query position's word (``q_allowed``, bool[Q]: the
    offsets the batch's lookup table indexed) is looked up in the
    database index's CSR (``idx_offsets`` int32[4^w + 1], ``idx_positions``
    int32 subject scan-grid offsets, ascending within a word;
    lut/dbindex.py), and fans out to every subject position of its chain.
    The database soft mask applies per gathered subject position (a word
    overlapping an interval is not seeded). ``query`` is uint8[Q]
    BLASTNA; codes above 3 occur only at positions ``q_allowed``
    excludes. Returns int64 (q_off, s_off), ordered by query position,
    then chain slot: the lane order of the JAX package's compacted
    ``indexed_scan_block`` output."""
    dev = query.device
    n_scan = max(query.shape[0] - lut_word + 1, 0)
    q = query.to(torch.int64) & 3
    words = torch.zeros(n_scan, dtype=torch.int64, device=dev)
    for j in range(lut_word):
        words += q[j: j + n_scan] << (2 * (lut_word - 1 - j))
    valid = q_allowed[:n_scan]
    words = torch.where(valid, words, 0)
    start = idx_offsets[words].to(torch.int64)
    count = torch.where(valid, idx_offsets[words + 1].to(torch.int64)
                        - start, 0)
    hidx = torch.nonzero(count > 0).squeeze(1)
    q_off, s_off = _fan_out(hidx, start[hidx], count[hidx], idx_positions)
    if mask_starts is not None and mask_starts.numel():
        keep = torch.nonzero(~masked_words(
            s_off, lut_word, mask_starts, mask_ends)).squeeze(1)
        q_off, s_off = q_off[keep], s_off[keep]
    return q_off, s_off


def mini_extend(query, subject2, subject_valid, q_off, s_off, *,
                lut_word: int, word_size: int):
    """Extend lut_word seeds to word_size by exact base matching
    (s_BlastNaExtend, na_ungapped.c:1026), over byte codes. The plain
    twin of ``mini_extend_packed``. Returns (q_adj, s_adj, ok): the seed
    start shifted left by the left extension, and whether it survives
    (ext_left + ext_right >= word_size - lut_word)."""
    ext_to = word_size - lut_word
    ok = torch.ones(q_off.shape[0], dtype=torch.bool, device=q_off.device)
    if ext_to == 0:
        return q_off, s_off, ok
    S, Q = subject2.shape[0], query.shape[0]
    dev = q_off.device

    def run(qi, si):
        inb = (qi >= 0) & (qi < Q) & (si >= 0) & (si < S)
        qc = qi.clamp(0, Q - 1)
        sc = si.clamp(0, S - 1)
        m = (inb & subject_valid[sc]
             & (query[qc].long() == subject2[sc].long()))
        return torch.cumprod(m.long(), dim=1).sum(dim=1)

    steps = torch.arange(1, ext_to + 1, dtype=torch.int64, device=dev)
    ext_left = run(q_off[:, None] - steps, s_off[:, None] - steps)
    ext_left = ext_left.clamp(max=ext_to)
    stepsr = torch.arange(ext_to, dtype=torch.int64, device=dev)
    ext_right = run(q_off[:, None] + lut_word + stepsr,
                    s_off[:, None] + lut_word + stepsr)
    ok = ext_left + torch.minimum(ext_right, ext_to - ext_left) >= ext_to
    return q_off - ext_left, s_off - ext_left, ok


def _codes(words, base, per_word: int, bits: int, span: int):
    """[n, span] codes starting at ``base`` from packed words holding
    ``per_word`` codes of ``bits`` bits, first code highest."""
    j0 = torch.div(base, per_word, rounding_mode="floor")
    phase = base - j0 * per_word
    nw = (per_word - 1 + span + per_word - 1) // per_word + 1
    d = torch.arange(span, dtype=torch.int64, device=base.device)
    pos = phase[:, None] + d[None, :]
    k = pos // per_word
    sh = (per_word - 1 - pos % per_word) * bits
    last = words.shape[0] - 1
    ws = torch.stack(
        [words[(j0 + kk).clamp(0, last)] for kk in range(nw)], dim=1
    )
    return (torch.gather(ws, 1, k) >> sh) & ((1 << bits) - 1)


def mini_extend_packed(query_nib, subject_w, q_off, s_off, sub_lo, sub_hi,
                       *, lut_word: int, word_size: int):
    """``mini_extend`` on packed words: query 4na-mask nibbles (8 per
    word) and subject 2-bit codes (16 per word), with the owning
    subject's [sub_lo, sub_hi) as the validity bound. Same returns."""
    ext_to = word_size - lut_word
    ok = torch.ones(q_off.shape[0], dtype=torch.bool, device=q_off.device)
    if ext_to == 0:
        return q_off, s_off, ok
    span = lut_word + 2 * ext_to      # [q_off - ext_to, q_off + W + ext_to)
    qmask = _codes(query_nib, q_off - ext_to, 8, 4, span)
    scode = _codes(subject_w, s_off - ext_to, 16, 2, span)
    d = torch.arange(span, dtype=torch.int64, device=q_off.device) - ext_to
    qi = q_off[:, None] + d
    si = s_off[:, None] + d
    inb = ((qi >= 0) & (qi < query_nib.shape[0] * 8)
           & (si >= sub_lo.clamp(min=0)[:, None])
           & (si < sub_hi.clamp(max=subject_w.shape[0] * 16)[:, None]))
    # query nibbles are 4na masks: exact base match iff mask == 1 << code
    match = inb & (qmask == (torch.ones_like(scode) << scode))
    m_l = match[:, :ext_to].flip(1)
    ext_left = torch.cumprod(m_l.long(), dim=1).sum(dim=1).clamp(max=ext_to)
    m_r = match[:, ext_to + lut_word:]
    ext_right = torch.cumprod(m_r.long(), dim=1).sum(dim=1)
    ok = ext_left + torch.minimum(ext_right, ext_to - ext_left) >= ext_to
    return q_off - ext_left, s_off - ext_left, ok


def owning_subject(s_off, starts):
    """Index of the subject whose [start, next start) holds s_off."""
    oid = torch.searchsorted(starts, s_off, right=True) - 1
    return oid.clamp(0, starts.shape[0] - 1)


def seeding_scan_mini(subject2, subject_valid, lut_offsets, lut_positions,
                      query_nib, subject_w, ctx_offsets, x_dropoffs,
                      subject_starts, subject_ends, *, query_len: int,
                      scan_step: int, lut_word: int, word_size: int,
                      n_scan: int, disc_offsets=None, mask_starts=None,
                      mask_ends=None, query=None, q_allowed=None,
                      chunk: int = SCAN_CHUNK, first: int = 0):
    """Scan -> mini-extension -> per-survivor context, X-drop and walk
    budgets (the inputs of K1).

    ``ctx_offsets`` int64[n_ctx+1] context starts in the query buffer;
    ``x_dropoffs`` int32[n_ctx]. With ``disc_offsets`` (a discontiguous
    template, whose word is the whole template window) there is no
    mini-extension: every raw seed goes on (s_BlastNaExtendDirect,
    na_ungapped.c:941). ``mask_starts`` / ``mask_ends`` are the database
    soft-mask intervals, and ``chunk`` and ``first`` the scan's positions
    a step and its first position (``scan_block``). With ``q_allowed`` (indexed megablast) the raw
    seeds come from ``indexed_scan_block`` over ``query`` (uint8 BLASTNA
    codes), and ``lut_offsets`` / ``lut_positions`` hold the database
    index. Returns (qs, ss, ctx, x_drop, max_l, max_r, n_raw): int64 seed
    starts, then int32 kernel inputs, for the mini-extension survivors
    only, and the raw seed count."""
    if q_allowed is not None:
        q_off, s_off = indexed_scan_block(
            query, q_allowed, lut_offsets, lut_positions,
            lut_word=lut_word, mask_starts=mask_starts, mask_ends=mask_ends)
    else:
        q_off, s_off = scan_block(
            subject2, subject_valid, lut_offsets, lut_positions,
            scan_step=scan_step, lut_word=lut_word, n_scan=n_scan,
            disc_offsets=disc_offsets, mask_starts=mask_starts,
            mask_ends=mask_ends, chunk=chunk, first=first)
    if disc_offsets:
        qs, ss = q_off, s_off
    else:
        # MINI_CHUNK raw seeds a step, survivors concatenated in order:
        # the extension's [seeds, span] temporaries stay bounded however
        # many seeds a genome-scale scan finds
        parts = []
        for a in range(0, max(q_off.shape[0], 1), MINI_CHUNK):
            qa, sa = q_off[a: a + MINI_CHUNK], s_off[a: a + MINI_CHUNK]
            # owning-subject bounds before the extension (it never
            # crosses the inter-subject pad, so the subject is stable
            # under the left shift)
            oid = owning_subject(sa, subject_starts)
            qa, sa, ok = mini_extend_packed(
                query_nib, subject_w, qa, sa,
                subject_starts[oid], subject_ends[oid],
                lut_word=lut_word, word_size=word_size,
            )
            keep = torch.nonzero(ok).squeeze(1)
            parts.append((qa[keep], sa[keep]))
        qs, ss = (parts[0] if len(parts) == 1
                  else tuple(torch.cat(c) for c in zip(*parts)))

    n_ctx = x_dropoffs.shape[0]
    ctx = (torch.searchsorted(ctx_offsets, qs, right=True) - 1).clamp(
        0, n_ctx - 1
    )
    xd = x_dropoffs[ctx]
    # walk budgets: stay inside the query buffer and the owning subject
    oid = owning_subject(ss, subject_starts)
    sub_l = ss - subject_starts[oid]
    sub_r = subject_ends[oid] - ss
    max_l = torch.minimum(torch.minimum(qs, ss), sub_l).clamp(min=0)
    max_r = torch.minimum(
        torch.minimum(query_len - qs, subject2.shape[0] - ss), sub_r
    ).clamp(min=0)
    i32 = torch.int32
    return (qs, ss, ctx, xd.to(i32), max_l.to(i32), max_r.to(i32),
            int(q_off.shape[0]))
