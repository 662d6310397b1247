"""Device seeding stage in PyTorch: subject scan, seed resolution and
mini-extension.

The port's counterpart of the parts of ``gblastn_tpu/ops/seeding.py`` on
the megablast main path (reference: NCBI blast_nascan.c scanners and
na_ungapped.c:1026 ``s_BlastNaExtend``). Shapes are exact: every function
returns only real seeds, in the JAX package's lane order (scan position
ascending, then CSR slot, then mini-extension survivors in order), so the
final stable score sort sees the same pre-order.

Packed words are held as int64 (values < 2^32): shifts of int32 are
arithmetic and torch.uint32 supports few operators.
"""
from __future__ import annotations

import numpy as np
import torch

from gblastn_tpu_torch.io.encoding import BLASTNA_TO_NCBI4NA


def unpack_2na(packed: torch.Tensor) -> torch.Tensor:
    """uint8 packed (4 bases/byte, first base in the high bits) -> int8
    codes."""
    p = packed.to(torch.int32)
    cols = torch.stack([(p >> 6) & 3, (p >> 4) & 3, (p >> 2) & 3, p & 3],
                       dim=-1)
    return cols.reshape(-1).to(torch.int8)


def valid_from_intervals(S: int, starts: torch.Tensor,
                         ends: torch.Tensor) -> torch.Tensor:
    """bool[S] validity mask from per-subject [start, end) intervals."""
    d = torch.zeros(S + 1, dtype=torch.int32, device=starts.device)
    one = torch.ones(starts.shape[0], dtype=torch.int32,
                     device=starts.device)
    d.index_add_(0, starts.long().clamp(0, S), one)
    d.index_add_(0, ends.long().clamp(0, S), -one)
    return torch.cumsum(d[:S], dim=0) > 0


def pack_subject_words(packed: torch.Tensor) -> torch.Tensor:
    """uint8[S/4] packed bytes -> int64[ceil(S/16)] words of 16 bases,
    first base in the highest 2 bits of the low 32 (the gather unit of
    mini_extend_packed). Byte counts not a multiple of 4 are zero-padded
    to the word."""
    pad = (-packed.shape[0]) % 4
    if pad:
        packed = torch.cat([packed, packed.new_zeros(pad)])
    b = packed.view(-1, 4).to(torch.int64)
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]


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


def _presence_hits(words, valid_word, lut_offsets):
    """Scan positions whose word has a CSR chain, via the bit-packed
    presence vector (the PV texture of the reference GPU scan,
    gpu_blastn_mb_scan_kernel_v3.cuh:26): the random probes touch a
    table 32x smaller than the offsets."""
    table_size = lut_offsets.shape[0] - 1
    present = lut_offsets[1:] > lut_offsets[:-1]
    if table_size % 32 or table_size < 4096:
        return valid_word & present[words]
    bits = present.view(table_size // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    pv = (bits << shifts).sum(dim=1)
    return valid_word & (((pv[words >> 5] >> (words & 31)) & 1) == 1)


def scan_span(lut_word: int, disc_offsets=None) -> int:
    """The bases a scan word reads: ``lut_word`` consecutive ones, or a
    discontiguous template's whole window."""
    return disc_offsets[-1] + 1 if disc_offsets else lut_word


def scan_block(subject2, subject_valid, lut_offsets, lut_positions, *,
               scan_step: int, lut_word: int, n_scan: int,
               disc_offsets=None):
    """Scan the subject at stride positions and resolve CSR seeds.

    Word codes are taken at positions ``k * scan_step`` (k < n_scan) from
    ``lut_word`` consecutive valid bases, or with ``disc_offsets`` (a
    discontiguous template) from the bases at those offsets of a window
    that must be valid throughout (s_FillDiscMBTable resets on any
    ambiguity, blast_nalookup.c:757); positions whose word has a chain
    fan out to every query offset of the chain. Returns int64 (q_off,
    s_off), ordered by scan position, then chain slot."""
    dev = subject2.device
    offs = tuple(disc_offsets) if disc_offsets else tuple(range(lut_word))
    w = len(offs)
    pos = torch.arange(n_scan, dtype=torch.int64, device=dev) * scan_step
    words = torch.zeros(n_scan, dtype=torch.int64, device=dev)
    valid_word = torch.ones(n_scan, dtype=torch.bool, device=dev)
    for r, j in enumerate(offs):
        words += subject2[pos + j].to(torch.int64) << (2 * (w - 1 - r))
    for j in range(scan_span(lut_word, disc_offsets)):
        valid_word &= subject_valid[pos + j]
    words = torch.where(valid_word, words, 0)
    hit = _presence_hits(words, valid_word, lut_offsets)
    hidx = torch.nonzero(hit).squeeze(1)
    w_h = words[hidx]
    start = lut_offsets[w_h].to(torch.int64)
    count = lut_offsets[w_h + 1].to(torch.int64) - start
    # CSR fan-out: one seed per chain slot
    first = torch.cumsum(count, dim=0) - count
    slot = (torch.arange(int(count.sum()), device=dev)
            - torch.repeat_interleave(first, count))
    q_off = lut_positions[torch.repeat_interleave(start, count) + slot]
    s_off = torch.repeat_interleave(pos[hidx], count)
    return q_off.to(torch.int64), s_off


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
                      n_scan: int, disc_offsets=None):
    """Scan -> mini-extension -> per-survivor context, X-drop and walk
    budgets (the inputs of K1).

    ``ctx_offsets`` int64[n_ctx+1] context starts in the query buffer;
    ``x_dropoffs`` int32[n_ctx]. With ``disc_offsets`` (a discontiguous
    template, whose word is the whole template window) there is no
    mini-extension: every raw seed goes on (s_BlastNaExtendDirect,
    na_ungapped.c:941). Returns (qs, ss, ctx, x_drop, max_l, max_r,
    n_raw): int64 seed starts, then int32 kernel inputs, for the
    mini-extension survivors only, and the raw seed count."""
    q_off, s_off = scan_block(
        subject2, subject_valid, lut_offsets, lut_positions,
        scan_step=scan_step, lut_word=lut_word, n_scan=n_scan,
        disc_offsets=disc_offsets,
    )
    if disc_offsets:
        qs, ss = q_off, s_off
    else:
        # owning-subject bounds before the extension (it never crosses
        # the inter-subject pad, so the subject is stable under the left
        # shift)
        oid = owning_subject(s_off, subject_starts)
        qs, ss, ok = mini_extend_packed(
            query_nib, subject_w, q_off, s_off,
            subject_starts[oid], subject_ends[oid],
            lut_word=lut_word, word_size=word_size,
        )
        keep = torch.nonzero(ok).squeeze(1)
        qs, ss = qs[keep], ss[keep]

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
