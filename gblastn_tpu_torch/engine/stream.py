"""Subject block streaming: seeding over a database past the card's
memory.

The port's counterpart of ``gblastn_tpu/engine/stream.py``. The
reference streams subjects through its engine in chunks with an overlap
and merges the chunk-crossing HSPs afterwards (NCBI blast_engine.c:
220-305, blast_hits.c:2545 ``Blast_HSPListsMerge``); as in the JAX
package there is no merge here:

* the card holds one block's forms at a time (``block_bases`` of core
  and a ``halo`` of real subject context on each side) instead of the
  whole database's, so its memory grows with the block and the seeds,
  not the database;
* each block owns a disjoint range of global stride positions, scanned
  from its halo on (``scan_parts(first=halo)``), so the scan keeps the
  global stride phase: the seed set is the resident scan's, and no seed
  is found twice;
* extensions run inside the block's buffer; the few whose walk may have
  stopped at the buffer's edge while the subject goes on (K1's that ran
  into their budget, and G's demoted walks whose budget the buffer cut)
  are re-extended and gated exactly on the host off the packed database
  (``ungapped_extend_host``, ``engine.seeding.host_gate``), so the
  results equal the resident path's;
* blocks upload the 2-bit packed bytes, kept across batches in a device
  cache (up to ``CACHE_BYTES``, less where the card's free memory is
  short), and unpack on the card with the resident path's own helpers
  (ops.seeding);
* each block's seed columns stay on the card in global int64
  coordinates, and the resident path's finish runs once over all of them.

Per block the card runs the scan and the mini-extension, K1, RR where
``probes_double_words`` holds, and G; a block is launched and its forms
freed before the next one's (the scan waits on the card to size its seed
arrays). Then one fetch brings the seeds to escalate, and the sort and R
run on the card over the whole database's seeds with one fetch of the
saved ones, as on the resident path; with a scan range the host replays
every seed (``host_finish``), as it does there. The device gapped
filter K2 reads the resident subject, so a streamed batch does not run
it; K2 is an exact rejection filter, so leaving it out changes no
result. The sharded path (parallel.dist) runs the same block launch,
escalation and finish on shards that stay resident on their cards.

``choose`` decides where a batch's database lives: ``GBLASTN_TPU_STREAM
=1`` forces streaming, ``=0`` forbids it, ``GBLASTN_TPU_STREAM_THRESHOLD``
(bases; read only where it is set) streams past it, and otherwise the
port streams exactly where the resident form and a search's working
memory do not fit in the card's free memory (engine.resident). The
streamed path holds its own need, one block's forms and its working
memory (``stream_bytes``), against the same free memory
(``stream_decision``).

Left out, as TPU workarounds that were exact: the JAX package's
``_CAP_CACHE`` with the hit, seed and alive caps and their overflow
retries, ``_pack_stream``'s bitfields with its ``wide`` escalation bit,
``pos_base_static``, the pow2 buckets of the subject, mask and index
slices (sizes are exact), and the XLA/Pallas split with phase 0 and
``_pallas_alive_only``.
"""
from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass, replace

import numpy as np
import torch

from gblastn_tpu_torch.engine.resident import (
    BYTES_PER_BASE,
    SEARCH_WORK_BYTES,
    ResidentDB,
    free_bytes,
    resident_bytes,
)
from gblastn_tpu_torch.engine.seeding import (
    InitHits,
    SeedingDeviceData,
    _halves,
    fetch_saved,
    gate_rows,
    host_finish,
    host_gate,
    join_parts,
    offdiag_rows,
    replay_rows,
    scan_parts,
)
from gblastn_tpu_torch.io.encoding import unpack_2na as unpack_2na_host
from gblastn_tpu_torch.ops.replay import FLAG_DEMOTE, check_gate_flags
from gblastn_tpu_torch.ops.seeding import (
    BUILD_CHUNK,
    pack_subject_words,
    unpack_2na,
    valid_from_intervals,
)
from gblastn_tpu_torch.ops.ungapped import check_flags, ungapped_extend_window
from gblastn_tpu_torch.utils.profiling import slog

CLIP = 1 << 30     # block-local subject bounds are clipped to +-CLIP: they
                   # only feed min() with the buffer's own bounds


# ------------------------------------------------------------------ host ops
def unpack_range(packed: np.ndarray, p0: int, p1: int) -> np.ndarray:
    """2-bit codes for global base positions [p0, p1) (p0, p1 >= 0)."""
    b0, b1 = p0 >> 2, (p1 + 3) >> 2
    codes = unpack_2na_host(packed[b0:b1], (b1 - b0) * 4)
    return codes[p0 - 4 * b0: p1 - 4 * b0]


def _xdrop_dir_host(fetch, max_steps: int, x: int, chunk: int = 8192):
    """Exact host walk of one direction (the reset-at-best accumulation
    of s_NuclUngappedExtendExact, na_ungapped.c:152). ``fetch(base, k)``
    returns the scores of steps base+1 .. base+k. Returns (best,
    best_pos), best floored at 0 (pos 0 if best is 0)."""
    s = 0
    best = 0
    best_pos = 0
    base = 0
    while base < max_steps:
        k = min(chunk, max_steps - base)
        sc = fetch(base, k).astype(np.int64)
        cs = s + np.cumsum(sc)
        run = np.maximum.accumulate(cs)
        prev = np.empty_like(run)
        prev[0] = best
        if k > 1:
            np.maximum(best, run[:-1], out=prev[1:])
        dropped = (cs - prev) < -x
        any_drop = bool(dropped.any())
        stop = int(np.argmax(dropped)) if any_drop else k - 1
        live = cs[: stop + 1]
        m = int(live.max())
        if m > best:
            best = m
            best_pos = base + int(np.argmax(live == m)) + 1
        if any_drop:
            break
        s = int(cs[-1])
        base += k
    return best, best_pos


def ungapped_extend_host(
    query: np.ndarray,            # uint8[Q] BLASTNA with sentinels
    matrix16: np.ndarray,         # int32[16, 4] (device_matrix16)
    packed: np.ndarray,           # uint8 packed DB
    sub_start: np.ndarray,        # int64[n] subject start per seed
    sub_end: np.ndarray,          # int64[n] subject end per seed
    q_off: np.ndarray,
    s_off: np.ndarray,            # int64[n] global base positions
    x_drop: np.ndarray,
):
    """Exact two-way X-drop extension on the host, straight off the
    packed database: K1's semantics (``ops.ungapped``) with the true
    budgets. Used for the few streamed seeds whose walk on the card
    stopped at a buffer edge; a Python loop a seed. Returns int64
    (q_start, s_start, length, score)."""
    Q = len(query)
    n = len(q_off)
    uq = np.zeros(n, np.int64)
    us = np.zeros(n, np.int64)
    ulen = np.zeros(n, np.int64)
    uscore = np.zeros(n, np.int64)
    m16 = matrix16.astype(np.int64)
    for i in range(n):
        qo = int(q_off[i])
        so = int(s_off[i])
        x = int(x_drop[i])
        max_l = min(qo, so - int(sub_start[i]))
        max_r = min(Q - qo, int(sub_end[i]) - so)

        def fetch_l(base, k, qo=qo, so=so):
            qseg = query[qo - base - k: qo - base][::-1].astype(np.int64)
            sseg = unpack_range(packed, so - base - k, so - base)[::-1]
            return m16[qseg, sseg.astype(np.int64)]

        def fetch_r(base, k, qo=qo, so=so):
            qseg = query[qo + base: qo + base + k].astype(np.int64)
            sseg = unpack_range(packed, so + base, so + base + k)
            return m16[qseg, sseg.astype(np.int64)]

        l_best, l_pos = _xdrop_dir_host(fetch_l, max_l, x)
        r_best, r_pos = _xdrop_dir_host(fetch_r, max_r, x)
        uq[i] = qo - l_pos
        us[i] = so - l_pos
        ulen[i] = l_pos + r_pos
        uscore[i] = l_best + r_best
    return uq, us, ulen, uscore


# ------------------------------------------------------------------ geometry
class _BlockPlan:
    """Static geometry of one search's stream. Block k owns the global
    stride positions [kB, min((k+1)B, npos)) and its buffer holds the
    global bases [kB - halo, (k+1)B + halo). B is a multiple of
    lcm(1024, scan_step), so every block's first scan position sits at
    local offset ``halo`` with the global stride phase; the halo is a
    multiple of 4 (the buffer starts on a packed byte) and at least 256
    (a word, its mini-extension and its double-word run stay inside).
    Sizes are exact: a block's subject and mask slices hold what
    overlaps its buffer."""

    def __init__(self, db, *, block_bases: int, halo: int, span: int,
                 scan_step: int, mask_intervals=None,
                 n_blocks: int | None = None):
        align = math.lcm(1024, scan_step)
        self.B = max(block_bases - block_bases % align, align)
        self.halo = max(halo - halo % 4, 256)
        self.s_buf = self.B + 2 * self.halo
        s_pad = db.padded_length
        self.npos = s_pad - span + 1
        # ``n_blocks`` past the database's last block adds blocks with no
        # work (a shard plan keeps its shard count)
        self.n_blocks = max(n_blocks or 0, (s_pad + self.B - 1) // self.B)
        self.scan_step = scan_step
        starts = np.asarray(db.starts, np.int64)
        ends = starts + np.asarray(db.lengths, np.int64)
        self.starts, self.ends = starts, ends
        # per block: buffer origin g0 and the subjects [a, b) overlapping
        # the buffer
        self.slices = []
        for k in range(self.n_blocks):
            g0 = k * self.B - self.halo
            a = int(np.searchsorted(ends, g0, side="right"))
            b = int(np.searchsorted(starts, g0 + self.s_buf, side="left"))
            self.slices.append((g0, a, b))
        self.mask_slices = None
        if mask_intervals is not None and len(mask_intervals):
            mi = np.asarray(mask_intervals, np.int64)
            self.mask_slices = []
            for g0, _a, _b in self.slices:
                lo = int(np.searchsorted(mi[:, 1], max(g0, 0), "right"))
                hi = int(np.searchsorted(mi[:, 0], g0 + self.s_buf, "left"))
                self.mask_slices.append((lo, hi))

    def n_scan(self, k: int) -> int:
        """Block k's own stride positions, from local offset ``halo``."""
        p_hi = min((k + 1) * self.B, self.npos)
        return max(-(-(p_hi - k * self.B) // self.scan_step), 0)

    def has_work(self, k: int) -> bool:
        g0, a, b = self.slices[k]
        return b > a and self.n_scan(k) > 0

    def packed(self, db, k: int) -> np.ndarray:
        """uint8[s_buf / 4]: the packed bytes of block k's buffer (zero
        outside the database)."""
        g0 = self.slices[k][0]
        buf = np.zeros(self.s_buf // 4, np.uint8)
        src0 = max(g0, 0) >> 2
        src1 = min((g0 + self.s_buf) >> 2, len(db.packed))
        if src1 > src0:
            dst0 = src0 - (g0 >> 2)
            buf[dst0: dst0 + (src1 - src0)] = db.packed[src0:src1]
        return buf

    def bounds(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """int64 block-local starts and ends of block k's subjects,
        clipped to +-CLIP."""
        g0, a, b = self.slices[k]
        return (np.clip(self.starts[a:b] - g0, -CLIP, CLIP),
                np.clip(self.ends[a:b] - g0, -CLIP, CLIP))

    def block_bytes(self) -> int:
        """Device bytes of one block's forms (packed, codes, validity,
        words)."""
        return int(self.s_buf * BYTES_PER_BASE)


def _block_index_slices(db, db_index, plan: _BlockPlan) -> list:
    """Per-block (words, local positions) slices of the database word
    index, cached on the db. Block k owns the global scan-grid positions
    [kB, min((k+1)B, npos)), the partition the streamed scan uses, so a
    stable position-range filter of the word-sorted index arrays gives
    sub-indices whose union is the whole index (and so the scan's seed
    set); words stay sorted within a slice. Sizes are exact."""
    key = (plan.B, plan.halo, db_index.lut_word, db_index.word_size,
           id(db_index))
    cache = getattr(db, "_torch_stream_index", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    pos = db_index.positions.astype(np.int64)
    words = db_index.words
    out = []
    for k in range(plan.n_blocks):
        g0 = plan.slices[k][0]
        m = (pos >= k * plan.B) & (pos < min((k + 1) * plan.B, plan.npos))
        out.append((np.ascontiguousarray(words[m], np.int64),
                    (pos[m] - g0).astype(np.int32)))
    db._torch_stream_index = (key, out)
    return out


# ------------------------------------------------------------ where it lives
# the device block cache's most, the JAX package's default; less where
# the card's free memory is short of it (``choose``)
CACHE_BYTES = 4 << 30
# device memory a streamed search takes beside one block's forms, their
# build chunk and the block cache: the scan's and mini-extension's chunks
# of a block (ops.seeding SCAN_CHUNK, MINI_CHUNK), every block's seed
# columns, the sort and R over them. On an H100 the allocator's peak
# reserve beside the cache was 1.58e9 bytes for giant (100 reads, 24
# blocks of 2^27 bases) and 1.48 GiB allocated for config 3s (500 reads,
# 3 blocks), of which one block's forms and build chunk take 0.91e9;
# 1.5 GiB puts the need about 1.6x above both (chip_smoke.py holds both
# peaks against ``stream_bytes``)
STREAM_WORK_BYTES = 3 << 29


def stream_decision(*, env: str, threshold: int | None, padded_length: int,
                    resident_need: int, stream_need: int,
                    free: int | None) -> tuple[bool, str]:
    """Whether a batch streams, and why: (stream, reason). ``env`` is
    GBLASTN_TPU_STREAM ("1" forces, "0" forbids, anything else decides),
    ``threshold`` GBLASTN_TPU_STREAM_THRESHOLD in bases (None where it is
    not set), ``resident_need`` and ``stream_need`` the device bytes of
    each path with its working memory, and ``free`` the card's free bytes
    (None on the CPU, whose allocator answers for itself). Raises
    MemoryError, naming both numbers, where the chosen path does not fit:
    the resident form with streaming forbidden, or the streamed path's
    own need."""
    def stream(reason):
        if free is not None and stream_need > free:
            raise MemoryError(
                f"the streamed search needs {stream_need} bytes of device "
                f"memory (a block's forms and a streamed search's working "
                f"memory) and the card has {free} free ({reason})")
        return True, reason

    if env == "1":
        return stream("GBLASTN_TPU_STREAM=1")
    fits = free is None or resident_need <= free
    if env == "0":
        if not fits:
            raise MemoryError(
                f"the resident database and a search need {resident_need} "
                f"bytes of device memory and the card has {free} free; "
                "GBLASTN_TPU_STREAM=0 forbids streaming")
        return False, "GBLASTN_TPU_STREAM=0"
    if threshold is not None and padded_length > threshold:
        return stream(f"the database's {padded_length} bases pass "
                      f"GBLASTN_TPU_STREAM_THRESHOLD={threshold}")
    if fits:
        return False, "the resident form fits"
    return stream(f"the resident database and a search need "
                  f"{resident_need} bytes of device memory and the card "
                  f"has {free} free")


def stream_bytes(plan: _BlockPlan, num_seqs: int) -> int:
    """Device bytes a streamed search needs beside its block cache: one
    block's forms, the largest transient of their build, the subject
    bounds and ``STREAM_WORK_BYTES``."""
    chunk = min(BUILD_CHUNK, plan.s_buf // 4 + 1)
    return (plan.block_bytes() + 16 * chunk + 16 * num_seqs
            + STREAM_WORK_BYTES)


@dataclass
class StreamedDB:
    """A batch's streamed database: the plan, the host data the blocks
    are cut from, and the device cache."""

    db: object                   # io.seqdb.SequenceDB
    plan: _BlockPlan
    device: torch.device
    cache_budget: int            # bytes of the device block cache
    index_slices: list | None    # per-block index slices (-use_index)
    index_key: tuple | None      # the index those slices were cut from
    matrix16: np.ndarray         # int32[16, 4] (host escalation)
    query: np.ndarray            # uint8[Q] the batch's query buffer


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _cache(db, device, plan: _BlockPlan) -> dict:
    """The device block cache of ``db`` on ``device`` for ``plan``'s
    geometry (a new geometry starts it afresh): packed blocks under
    ("packed", k), index slices under ("index", index key, k)."""
    caches = getattr(db, "_torch_stream_cache", None)
    if caches is None:
        caches = {}
        db._torch_stream_cache = caches
    c = caches.get(device)
    if c is None or c["geom"] != (plan.B, plan.halo):
        c = {"geom": (plan.B, plan.halo), "blocks": {}, "bytes": 0}
        caches[device] = c
    return c


def choose(db, device: torch.device, *, span: int, scan_step: int,
           mask_intervals, db_index, matrix16: np.ndarray,
           query: np.ndarray) -> StreamedDB | None:
    """The batch's StreamedDB where it streams (``stream_decision`` over
    the environment, the database and the card's free memory; one stderr
    line a database and reason), else None: the resident path, at once
    where the resident form is on the device and streaming is not
    forced. The block cache takes what the card has free beside the
    streamed search's need, up to ``CACHE_BYTES``."""
    env = os.environ.get("GBLASTN_TPU_STREAM", "")
    if (env != "1"
            and getattr(db, "_torch_resident", {}).get(device) is not None):
        return None
    thr = os.environ.get("GBLASTN_TPU_STREAM_THRESHOLD")
    plan = _BlockPlan(
        db, block_bases=_env_int("GBLASTN_TPU_BLOCK_BASES", 1 << 27),
        halo=_env_int("GBLASTN_TPU_BLOCK_HALO", 4096), span=span,
        scan_step=scan_step, mask_intervals=mask_intervals)
    free = free_bytes(device) if device.type == "cuda" else None
    resident_need = (resident_bytes(db.padded_length, db.num_seqs)
                     + SEARCH_WORK_BYTES)
    stream_need = stream_bytes(plan, db.num_seqs)
    streams, reason = stream_decision(
        env=env, threshold=None if thr is None else int(thr),
        padded_length=db.padded_length, resident_need=resident_need,
        stream_need=stream_need, free=free)
    if not streams:
        return None
    said = getattr(db, "_torch_stream_said", None)
    if said != reason:
        db._torch_stream_said = reason
        print(f"gblastn_tpu: streaming the database in {plan.n_blocks} "
              f"blocks of {plan.B} bases: {reason}", file=sys.stderr)
    budget = CACHE_BYTES
    if free is not None:
        held = _cache(db, device, plan)["bytes"]
        budget = min(CACHE_BYTES, max(held + free - stream_need, 0))
    return StreamedDB(
        db=db, plan=plan, device=device, cache_budget=budget,
        index_slices=(None if db_index is None
                      else _block_index_slices(db, db_index, plan)),
        index_key=(None if db_index is None
                   else (db_index.lut_word, db_index.word_size,
                         id(db_index))),
        matrix16=matrix16, query=query)


# ---------------------------------------------------------------- the stream
def _on_card(sdb: StreamedDB, cache: dict, key, make):
    """The tensors ``make()`` gives (host arrays), on the card: from the
    device cache under ``key``, or uploaded (and cached while the budget
    allows)."""
    ent = cache["blocks"].get(key)
    if ent is not None:
        return ent
    with slog.time("device.seeding.stream.upload"):
        ent = tuple(torch.from_numpy(a).to(sdb.device) for a in make())
    nb = sum(t.numel() * t.element_size() for t in ent)
    if cache["bytes"] + nb <= sdb.cache_budget:
        cache["blocks"][key] = ent
        cache["bytes"] += nb
    return ent


def _edge_walks(k1_args, ung, g_args, g_flags, lo, hi, *, s_buf: int,
                concat_end: int) -> torch.Tensor:
    """uint8[n]: a block's seeds whose walk on the card may have stopped
    at the buffer's edge while the subject goes on. K1's: a walk that ran
    into its budget (K1's bound bits 2 and 4) where the seed's true
    budget is larger. G's: a demoted seed whose walk's budget the buffer
    cut (G's walks run inside the buffer; a walk cut short scores at
    most what the whole walk would, so a seed G did not demote stands).
    ``lo`` and ``hi`` are the block's subject bounds, clipped to +-CLIP,
    which lies past every buffer. 1 marks K1's edges, 2 G's."""
    qs, ss = k1_args[3].long(), k1_args[4]
    oid = g_args[9].long()
    st, en = lo[oid], hi[oid]
    flags, max_l, max_r = ung[4], k1_args[6], k1_args[7]
    q_len = k1_args[0].numel()
    edge = ((((flags & 2) != 0) & (torch.minimum(qs, ss - st) > max_l))
            | (((flags & 4) != 0)
               & (torch.minimum(q_len - qs, en - ss) > max_r)))
    edge = edge.to(torch.uint8)
    if g_flags is None:
        return edge
    # G's left and right budgets in byte-steps (ops.replay.approx_gate_ref)
    adj = (4 - ((ss - st) & 3)) & 3
    q_ext = qs - 1 + adj

    def budgets(a, b):
        return (torch.minimum(q_ext, ss - a + adj) >> 2,
                torch.minimum(concat_end - 1 - q_ext, b - ss - adj) >> 2)

    n_l, n_r = budgets(st, en)
    b_l, b_r = budgets(st.clamp(0, s_buf), en.clamp(0, s_buf))
    g_edge = ((g_flags & FLAG_DEMOTE) != 0) & ((n_l > b_l) | (n_r > b_r))
    return edge | (g_edge.to(torch.uint8) << 1)


def block_resident(plan: _BlockPlan, k: int,
                   packed: torch.Tensor) -> ResidentDB:
    """Block k's resident form on ``packed``'s device, from its packed
    bytes with the resident path's helpers: codes, validity and words,
    and its subjects' block-local bounds (clipped to +-CLIP)."""
    device = packed.device
    lo, hi = (torch.from_numpy(b).to(device) for b in plan.bounds(k))
    subject2 = unpack_2na(packed)
    return ResidentDB(device=device, packed=packed, subject2=subject2,
                      valid=valid_from_intervals(subject2.shape[0], lo, hi),
                      subject_w=pack_subject_words(packed), starts=lo,
                      ends=hi, longest=plan.s_buf)


def _stream_forms(sdb: StreamedDB, cache: dict, k: int):
    """Block k's forms on the stream's card: (its ResidentDB, its index
    slice's words and local positions or None), the packed bytes and the
    index slice from the device cache or uploaded."""
    (packed,) = _on_card(sdb, cache, ("packed", k),
                         lambda: (sdb.plan.packed(sdb.db, k),))
    index = None
    if sdb.index_slices is not None:
        index = _on_card(sdb, cache, ("index", sdb.index_key, k),
                         lambda: sdb.index_slices[k])
    return block_resident(sdb.plan, k, packed), index


def launch_block(plan: _BlockPlan, k: int, res: ResidentDB, index,
                 dev: SeedingDeviceData, scan_kw: dict):
    """Block k on its forms' device (``res``, and ``index``, its index
    slice's words and local positions, or None; ``dev`` on the same
    device): the scan of its own positions (or its index slice), the
    mini-extension, K1, and RR and G (``gate_rows``; G's walks inside the
    buffer). Returns (item, raw seeds): the item is (seeds a template,
    columns, head), or None where the block has no seed: the seeds'
    columns in global coordinates (q, ctx, oid, int64 ss; the extension
    after G: uq, int64 us, ulen, usc; RR's runs where they ran; ``esc``,
    the walks at a buffer edge, ``_edge_walks``) and ``gate_rows``' head.
    Waits on the card only in the scan."""
    g0, a, _b = plan.slices[k]
    device = res.device
    lo, hi = res.starts, res.ends
    blk = {"resident": res}
    if plan.mask_slices is not None:
        m0, m1 = plan.mask_slices[k]
        blk["mask_starts"], blk["mask_ends"] = (
            (dev.mask_starts[m0:m1] - g0, dev.mask_ends[m0:m1] - g0)
            if m1 > m0 else (None, None))
    if index is not None:
        words, pos = index
        table = 1 << (2 * scan_kw["lut_word"])
        offsets = torch.zeros(table + 1, dtype=torch.int64, device=device)
        offsets[1:] = torch.cumsum(torch.bincount(words, minlength=table), 0)
        blk["lut_offsets"] = offsets.to(torch.int32)
        blk["lut_positions"] = pos
    bdev = replace(dev, **blk)
    parts = scan_parts(bdev, first=plan.halo, n_scan=plan.n_scan(k),
                       **scan_kw)
    counts = [int(p[0].numel()) for p in parts]
    n_raw = sum(p[6] for p in parts)
    if not sum(counts):
        return None, n_raw
    ctx, k1_args, _n = join_parts(bdev, parts)
    ung = ungapped_extend_window(*k1_args)
    s_buf = plan.s_buf
    gdev = replace(bdev, resident=replace(res, starts=lo.clamp(0, s_buf),
                                          ends=hi.clamp(0, s_buf)))
    g_args, runs, rows, head, g_flags = gate_rows(gdev, k1_args, ctx, ung,
                                                  scan_kw)
    concat_end = int(scan_kw["context_offsets"][dev.ctx_tables.shape[1]]) - 1
    qs, ss, ctx32, oid = g_args[6:10]
    uq, us, ulen, usc = rows
    cols = dict(q=qs, ctx=ctx32, oid=oid + a, ss=ss + g0, uq=uq,
                us=us + g0, ulen=ulen, usc=usc,
                esc=_edge_walks(k1_args, ung, g_args, g_flags, lo, hi,
                                s_buf=s_buf, concat_end=concat_end))
    if runs is not None:
        cols["runs"] = runs
    return (counts, cols, head), n_raw


def run_seeding_streamed(sdb: StreamedDB, dev: SeedingDeviceData,
                         **scan_kw) -> InitHits:
    """Streamed seeding over the whole database; the same InitHits as
    ``engine.seeding.run_seeding`` over the resident database (held equal
    in the tests). ``run_seeding_streamed_steps`` driven to its end."""
    from gblastn_tpu_torch.engine.seeding import drive

    return drive(run_seeding_streamed_steps(sdb, dev, **scan_kw))


def run_seeding_streamed_steps(sdb: StreamedDB, dev: SeedingDeviceData,
                               **scan_kw):
    """Generator form of ``run_seeding_streamed``: yields exactly once,
    after the first block's launch, so that a pipelining caller
    (engine.pipeline) runs host work meanwhile. ``dev`` holds the batch's
    device data without a resident database (its mask intervals are the
    database's, sliced per block); ``scan_kw`` are ``scan_parts``'
    keywords with the finish's ``scan_range``. No span is open across
    the yield: ``device.seeding.stream`` is timed in two parts."""
    plan = sdb.plan
    cache = _cache(sdb.db, sdb.device, plan)
    blocks = [k for k in range(plan.n_blocks) if plan.has_work(k)
              and (sdb.index_slices is None
                   or len(sdb.index_slices[k][1]))]
    got = []

    def launch(k):
        res, index = _stream_forms(sdb, cache, k)
        item, n_raw = launch_block(plan, k, res, index, dev, scan_kw)
        slog.diagnostics.lookup_hits += n_raw
        if item is not None:
            got.append(item)

    with slog.time("device.seeding.stream"):
        if blocks:
            launch(blocks[0])
    yield                                   # the first block launched
    with slog.time("device.seeding.stream"):
        for k in blocks[1:]:
            launch(k)
    slog.add_value("seeding.stream_blocks", len(blocks))
    return finish_blocks(sdb, dev, got, scan_kw)


def escalate(sdb: StreamedDB, dev: SeedingDeviceData, col: dict,
             head: list, scan_kw: dict, tag: str = "stream") -> None:
    """The walks at a buffer edge (``col["esc"]``), exactly on the host:
    one fetch of their seeds with K1's and G's range flags (which raise
    here, before a row is used), K1's extension off the packed database
    with the true budgets (``ungapped_extend_host``), then G
    (``host_gate``, for words of 11 and up), and the results written
    back into ``col``. Timed in ``host.<tag>_escalate`` and counted in
    the ``seeding.<tag>_escalated`` value, G's edges alone in
    ``seeding.<tag>_gate_edges`` (``tag``: stream or shard)."""
    idx = torch.nonzero(col["esc"]).squeeze(1)
    picks = [col["q"], col["ctx"], col["oid"], col["esc"].to(torch.int32)]
    if "runs" in col:
        picks.append(col["runs"])
    with slog.time("device.seeding.fetch"):
        out = torch.cat([torch.stack(head[1:]).to(torch.int32),
                         torch.stack([c[idx] for c in picks]).reshape(-1),
                         _halves(col["ss"][idx]).reshape(-1)]).cpu().numpy()
    check_flags(out[0:1])
    check_gate_flags(out[1:2])
    n = idx.numel()
    slog.add_value(f"seeding.{tag}_escalated", n)
    if not n:
        slog.add_value(f"seeding.{tag}_gate_edges", 0)
        return
    cols = out[2:].reshape(-1, n)
    slog.add_value(f"seeding.{tag}_gate_edges", int((cols[3] == 2).sum()))
    q, ctx, oid = (c.astype(np.int64) for c in cols[:3])
    runs = cols[4] if "runs" in col else None
    ss = np.stack(cols[-2:], 1).view(np.int64)[:, 0]
    plan = sdb.plan
    word_size = scan_kw["word_size"]
    with slog.time(f"host.{tag}_escalate"):
        rows = ungapped_extend_host(
            sdb.query, sdb.matrix16, sdb.db.packed, plan.starts[oid],
            plan.ends[oid], q, ss, np.asarray(scan_kw["x_dropoffs"])[ctx])
        fkw = dev.finish_kw
        if word_size >= 11:
            need = rows[3] >= np.asarray(fkw["word_cutoffs"])[ctx]
            if need.any():
                rows, _d = host_gate(fkw["approx_ctx"],
                                     fkw["subject_starts"], oid, q, ss, ctx,
                                     rows, need, runs, word_size)
    for name, r in zip(("uq", "us", "ulen", "usc"), rows):
        col[name][idx] = torch.from_numpy(np.asarray(r)).to(
            col[name].device, col[name].dtype)


def join_blocks(got: list) -> tuple[dict, list]:
    """The blocks' items (``launch_block``'s, on one device, in block
    order) joined in the resident path's order, template then block:
    (columns, head), the head's gated seeds summed and range flags
    taken at their most."""
    n_tmpl = len(got[0][0])
    pieces = [(cols, sum(counts[:t]), counts[t])
              for t in range(n_tmpl) for counts, cols, _h in got]
    col = {name: torch.cat([c[name][a: a + n] for c, a, n in pieces])
           for name in got[0][1]}
    heads = torch.stack([torch.stack(h) for _c, _cols, h in got])
    return col, [heads[:, 0].sum().to(torch.int32), heads[:, 1].amax(),
                 heads[:, 2].amax()]


def _no_hits() -> InitHits:
    z = np.zeros(0, dtype=np.int32)
    return InitHits(z, z, z, z, z, z, z, z)


def finish_blocks(sdb: StreamedDB, dev: SeedingDeviceData, got: list,
                     scan_kw: dict, tag: str = "stream") -> InitHits:
    """The stream's finish: the blocks' columns joined on the card in the
    resident path's order (``join_blocks``), the walks at a buffer edge
    re-extended on the host (``escalate``), then ``finish_joined``."""
    if not got:
        return _no_hits()
    with slog.time("device.seeding.finish"):
        col, head = join_blocks(got)
    slog.diagnostics.init_extends += int(col["q"].numel())
    escalate(sdb, dev, col, head, scan_kw, tag)
    return finish_joined(sdb, dev, col, head, scan_kw)


def finish_joined(sdb: StreamedDB, dev: SeedingDeviceData, col: dict,
                  head: list, scan_kw: dict) -> InitHits:
    """The resident path's finish over the whole database's seeds, joined
    and escalated (``col``, ``head``; on the batch's device): the sort and
    R on the card and one fetch of the saved seeds (``replay_rows``,
    ``fetch_saved``), or, with a scan range, one fetch of every seed's
    rows for the host's off-diagonal replay (``host_finish``)."""
    if not col["q"].numel():
        return _no_hits()
    seeds = (col["q"], col["ss"], col["ctx"], col["oid"])
    rows = (col["uq"], col["us"], col["ulen"], col["usc"])
    runs = col.get("runs")
    if dev.window > 0 and scan_kw.get("scan_range", 0) > 0:
        rows = offdiag_rows(col["q"], col["ctx"], col["ss"], rows, runs)
        with slog.time("device.seeding.fetch"):
            out = rows.cpu().numpy()
        slog.add_value("seeding.fetch_bytes", out.nbytes)
        return host_finish(dev, out, scan_kw)
    n_ctx = dev.ctx_tables.shape[1]
    starts = torch.from_numpy(sdb.plan.starts).to(sdb.device)
    longest = int(np.max(sdb.db.lengths, initial=1))
    with slog.time("device.seeding.finish"):
        rows, head_t, saved = replay_rows(
            dev, seeds, rows, runs, head, scan_kw,
            concat_end=int(scan_kw["context_offsets"][n_ctx]) - 1,
            bounds=(starts, longest))
    return fetch_saved(rows, head_t, saved)
