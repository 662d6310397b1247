"""The device rate of the seeding scan, stage by stage.

The port's counterpart of ``tools/prof_scan_rate.py``: 64 x 1 kb reads
against a 4.6 Mb genome at word 28 (LUT width 11), built through the
port's own ``io/`` and ``lut/``, and the port's real scan functions
timed in the two-depth loop of ``tools.timing.loop_timer`` (iteration k
scans the subject codes perturbed as ``(codes + k) & 3``):

  A   words only (``scan_block``'s strided loop)
  B   + the PV probe (``_presence_hits``, which builds the PV each call)
  C   + compaction (``torch.nonzero``)
  D1  ``scan_block``
  D3  + ``mini_extend_packed``
  D   ``seeding_scan_mini`` in full

Stages D2 and E of the reference timed TPU workarounds that the port
removed; each prints why it is not ported.

Run on the card:  python -m gblastn_tpu_torch.tools.prof_scan_rate
On the CPU:       ... --device cpu --small   (a small size; CPU times)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from gblastn_tpu_torch.device import resolve_device
from gblastn_tpu_torch.engine.resident import resident_from_reference
from gblastn_tpu_torch.io.query import build_query_block
from gblastn_tpu_torch.lut.builder import (
    build_lookup_table,
    unmasked_locations,
)
from gblastn_tpu_torch.ops.seeding import (
    _presence_hits,
    mini_extend_packed,
    owning_subject,
    pack_query_nibbles,
    scan_block,
    seeding_scan_mini,
)
from gblastn_tpu_torch.tools.timing import device_label, loop_timer
from gblastn_tpu_torch.tools.workloads import make_workload

WORD = 28
LUT_WORD = 11           # the reference's build_lookup_table(..., WORD, 11)
SMALL_LUT_WORD = 8      # --small: a 64K-entry table
X_DROP = 22


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gblastn_tpu_torch.tools.prof_scan_rate",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a small size for a CPU run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_label(dev)}")
    if args.small:
        db, reads = make_workload(num_queries=8, qlen=500,
                                  genome_len=100_000)
    else:
        db, reads = make_workload()
    qblock = build_query_block(reads, "both")
    co = qblock.context_offsets()
    locs = unmasked_locations(qblock.buffer, co)
    lut = build_lookup_table(qblock.buffer, locs, WORD,
                             SMALL_LUT_WORD if args.small else LUT_WORD)
    qbuf = np.full(1 << 17, 15, np.uint8)
    qbuf[: len(qblock.buffer)] = qblock.buffer

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    res = resident_from_reference(db, dev)
    S = res.length
    scan_step, lut_word = lut.scan_step, lut.lut_word_size
    n_scan = (S - lut_word) // scan_step + 1
    offs = t(lut.counts_offsets)
    positions = t(lut.positions)
    query_nib = pack_query_nibbles(t(qbuf))
    n_ctx = len(co) - 1
    ctx_off = t(np.asarray(co, np.int64))
    xdrops = t(np.full(n_ctx, X_DROP, np.int32))
    print(f"subject {S / 1e6:.1f} Mb, stride {scan_step}, lut_word "
          f"{lut_word}, n_scan {n_scan}, positions {len(lut.positions)}")

    pos = torch.arange(n_scan, dtype=torch.int64, device=dev) * scan_step
    scan_kw = dict(scan_step=scan_step, lut_word=lut_word, n_scan=n_scan)

    def words_of(s2):               # scan_block's loop
        words = torch.zeros(n_scan, dtype=torch.int64, device=dev)
        valid_word = torch.ones(n_scan, dtype=torch.bool, device=dev)
        for j in range(lut_word):
            words += s2[pos + j].to(torch.int64) << (2 * (lut_word - 1 - j))
            valid_word &= res.valid[pos + j]
        return torch.where(valid_word, words, 0), valid_word

    def stage_words(s2):
        return words_of(s2)[0].sum()

    def stage_words_pv(s2):
        return _presence_hits(*words_of(s2), offs).sum()

    def stage_words_pv_compact(s2):
        return torch.nonzero(_presence_hits(*words_of(s2), offs)).sum()

    def stage_scan_block(s2):
        q_off, s_off = scan_block(s2, res.valid, offs, positions, **scan_kw)
        return q_off.sum() + s_off.numel()

    def stage_scan_mini(s2):
        q_off, s_off = scan_block(s2, res.valid, offs, positions, **scan_kw)
        oid = owning_subject(s_off, res.starts)
        qs, ss, ok = mini_extend_packed(
            query_nib, res.subject_w, q_off, s_off, res.starts[oid],
            res.ends[oid], lut_word=lut_word, word_size=WORD)
        return qs.sum() + ss.sum() + ok.sum()

    def stage_full(s2):
        qs, ss, ctx, xd, max_l, max_r, n_raw = seeding_scan_mini(
            s2, res.valid, offs, positions, query_nib, res.subject_w,
            ctx_off, xdrops, res.starts, res.ends, query_len=len(qbuf),
            word_size=WORD, **scan_kw)
        return qs.sum() + max_l.sum() + max_r.sum() + n_raw

    def timer(fn, label):
        return loop_timer(fn, label, S, "Gbase/s", device=dev,
                          base=res.subject2)

    timer(stage_words, "A words-only")
    timer(stage_words_pv, "B +PV probe")
    timer(stage_words_pv_compact, "C +compact")
    timer(stage_scan_block, "D1 scan_block")
    print("D2 +seed compact: not ported (it timed compact_indices, the "
          "capped sort-based compaction the port replaced by exact-size "
          "torch.nonzero; D1 and D3 hold the port's)")
    timer(stage_scan_mini, "D3 +mini_extend_packed")
    full_ms = timer(stage_full, "D seeding_scan_mini")
    print("E full w/ packed mini: not ported (it set the JAX package's "
          "packed mini-extension blob against its unpacked one; the port "
          "has only the packed one, which D times)")
    print(f"# scan+mini device rate: {S / (full_ms / 1e3) / 1e9:.2f} "
          f"Gbases/s (two-depth loop: the fixed launch and sync cost "
          f"cancels)  [{device_label(dev)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
