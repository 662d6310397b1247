"""Micro-profiles of the scan's parts, and the table gather P1-P3.

The port's counterpart of ``tools/prof_scan_parts.py``, at its sizes (a
4.6 Mb subject, scan stride 17, LUT width 12, 270,588 scan positions, a
4^12-entry table) and with its draws (``default_rng(1)``, in its order).
Every part runs in the two-depth loop of ``tools.timing.loop_timer``:

  1. random gathers: the scan positions' probes into the 2 MiB int32 PV
     (and into the port's own int64 PV, 4 MiB), and into the 67 MB CSR
     offsets;
  2. the PV build from the offsets, as the port's scan does it inside
     every call (``ops/seeding.py::_presence_hits``);
  3. word compute: ``scan_block``'s strided loop, and the reference's
     packed-word variants (on int64 words: torch.uint32 lacks shifts);
  4. compaction with ``torch.nonzero``, the port's;
  5. P1-P3 through ``ops/gather.py``: the (8, 128), 262,144 and
     16,777,216 probes into the 2 MiB table in the global mode, and in
     the staged mode both into the PV of LUT width 10 (the table's
     first 128 KiB, one block's shared memory) and into the 2 MiB table
     itself (split across a cluster of 16 blocks); each checked
     bit-equal to ``tab[idx]`` and timed beside its plain version and
     ``tab[idx]`` (calls, and one launch alone); the staged geometry and
     the card's limit on clusters; a sweep of the staged grid's cluster
     count at 262,144 and 16 Mi probes; the staged mode's refusal of a
     table above ``MAX_STAGED_ENTRIES``; the larger two shapes also as
     loop stages.

Run on the card:  python -m gblastn_tpu_torch.tools.prof_scan_parts
On the CPU:       ... --device cpu --small   (a small size; CPU times)
``profile(argv)`` returns the gather's records (``chip_smoke.py`` reads
them); ``main(argv)`` its exit code.
"""
from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np
import torch

from gblastn_tpu_torch.device import resolve_device
from gblastn_tpu_torch.ops.gather import (
    MAX_STAGED_ENTRIES,
    max_active_clusters,
    slice_layout,
    slice_smem_bytes,
    staged_geometry,
    table_gather,
    table_gather_ref,
)
from gblastn_tpu_torch.tools.timing import (
    call_ms,
    device_label,
    graph_ms,
    loop_timer,
)


class Sizes(NamedTuple):
    S: int              # subject bases (a multiple of 16)
    step: int           # scan stride
    lut_w: int          # LUT width: the table has 4^lut_w entries
    gn: int             # P3's probe count
    huge: int           # the large probe count of part 5d
    staged: int         # the narrow staged table's entries (a power of 2)

    @property
    def n_scan(self) -> int:
        return (self.S - self.lut_w) // self.step + 1

    @property
    def table(self) -> int:
        return 4 ** self.lut_w


FULL = Sizes(S=4_600_000, step=17, lut_w=12, gn=262_144, huge=16_777_216,
             staged=32_768)          # 32,768 entries: the PV of width 10
SMALL = Sizes(S=200_000, step=17, lut_w=8, gn=4096, huge=65_536,
              staged=1024)
# the H100 SXM's memory rate (NVIDIA data sheet, 700 W), for the bound
HBM_BYTES_PER_S = 3.35e12
CALLS = 100             # back-to-back calls a timed call's mean is of


def reference_draws(sz: Sizes) -> dict[str, np.ndarray]:
    """The reference tool's draws from ``default_rng(1)`` in its order
    (pv, lut_off, packed, idx, idx2, tab, gidx, bigidx), then this
    tool's own (the part-5d probes)."""
    rng = np.random.default_rng(1)
    npv = sz.table // 32
    d = {}
    d["pv"] = rng.integers(0, 1 << 31, npv, np.int32)
    d["lut_off"] = np.sort(
        rng.integers(0, 130000, sz.table + 1)).astype(np.int32)
    d["packed"] = rng.integers(0, 256, sz.S // 4, np.uint8)
    d["idx"] = rng.integers(0, npv, sz.n_scan, np.int32)
    d["idx2"] = rng.integers(0, sz.table, sz.n_scan, np.int32)
    d["tab"] = rng.integers(0, 100, (npv,), np.int32)
    d["gidx"] = rng.integers(0, npv, (8, 128), np.int32)
    d["bigidx"] = rng.integers(0, npv, (sz.gn // 128, 128), np.int32)
    d["hugeidx"] = rng.integers(0, npv, sz.huge, np.int32)
    return d


def _size(nbytes: int) -> str:
    if nbytes >= 1 << 20:
        return f"{nbytes >> 20} MiB"
    return f"{nbytes >> 10} KiB"


def gather_bound_ms(tab: torch.Tensor, idx: torch.Tensor) -> float:
    """Least ms of ``tab[idx]`` on the card (bytes; there is no arithmetic
    beyond the addressing): each index read once, each output written
    once, and each 32-byte sector of the table that the indices touch
    read once. A sector is the least a read moves (the table starts on
    one: PyTorch's allocator aligns it), so a few probes into a large
    table are charged their sectors, not the table."""
    sectors = torch.unique(idx.reshape(-1) >> 3).numel()
    nbytes = 8 * idx.numel() + min(32 * sectors, 4 * tab.numel())
    return nbytes / HBM_BYTES_PER_S * 1e3


def _gather_record(label, tab, idx, staged, want, dev) -> dict:
    """One shape and mode of P1-P3 on the same tensors: the kernel held
    bit-equal to the reference tool's check (``want``, numpy's
    ``tab[idx]``) and to ``tab[idx]``; the mean of back-to-back calls of
    the kernel, its plain version and ``tab[idx]``; on the card, each one
    launch alone (a CUDA graph); the bytes bound. Prints two lines."""
    out = table_gather(tab, idx, staged=staged)
    err = int(np.abs(out.cpu().numpy().astype(np.int64) - want).max())
    ok = err == 0 and torch.equal(out, tab[idx])
    print(f"{label}: OK correct={ok}")
    fns = {"": lambda: table_gather(tab, idx, staged=staged),
           "plain_": lambda: table_gather_ref(tab, idx),
           "library_": lambda: tab[idx]}
    rec = {"n": idx.numel(), "table_entries": tab.numel(), "ok": ok,
           "max_abs_err": err,
           "bound_ms": gather_bound_ms(tab, idx), "bound_by": "bytes"}
    for k, fn in fns.items():
        rec[f"{k}ms"] = call_ms(fn, CALLS, dev)
        rec[f"{k}ms_graph"] = (graph_ms(fn, counted=(table_gather,))
                               if dev.type == "cuda" else None)
    if dev.type == "cuda":
        alone = (f"one launch alone (CUDA graph of 100): kernel "
                 f"{rec['ms_graph']:.5f}, plain {rec['plain_ms_graph']:.5f}, "
                 f"tab[idx] {rec['library_ms_graph']:.5f} ms")
    else:
        alone = "one launch alone: not measured on the cpu"
    print(f"   {rec['n']} probes, {_size(4 * tab.numel())} table, "
          f"{'staged' if staged else 'global'}: kernel {rec['ms']:.5f}, "
          f"plain {rec['plain_ms']:.5f}, tab[idx] {rec['library_ms']:.5f} "
          f"ms a call; {alone}; bytes bound {rec['bound_ms']:.4g} ms")
    return rec


def _time_gathers(n, tab, idx, tab_s, timer) -> None:
    """Part 5c: n probes as loop stages (index perturbation, gather,
    sum), each mode beside tab[idx] on the same tensors."""
    npv, ns = tab.numel(), tab_s.numel()
    kib, kib_s = _size(4 * npv), _size(4 * ns)

    def stage(t, mask, gather):
        return lambda x: gather(t, (idx + x[0].int()) & mask).sum()

    def staged(t, i):
        return table_gather(t, i, staged=True)

    timer(stage(tab, npv - 1, table_gather),
          f"5c gather {n} global {kib}", n)
    timer(stage(tab, npv - 1, staged), f"5c gather {n} staged {kib}", n)
    timer(stage(tab, npv - 1, lambda t, i: t[i]),
          f"5c tab[idx] {n} {kib}", n)
    timer(stage(tab_s, ns - 1, staged), f"5c gather {n} staged {kib_s}", n)
    timer(stage(tab_s, ns - 1, lambda t, i: t[i]),
          f"5c tab[idx] {n} {kib_s}", n)


def _limit(dev):
    """The card's limit on staged clusters, for staged_geometry."""
    return lambda c, smem: max_active_clusters(dev.index, c, smem)


def _geometry_line(tab, dev) -> int:
    """Prints the staged layout of ``tab`` and, on the card, how many
    such clusters it holds at once; returns that count (None on the
    cpu)."""
    c, sl, _ = slice_layout(tab.numel())
    smem = slice_smem_bytes(sl)
    head = (f"5g staged geometry {_size(4 * tab.numel())}: clusters of {c} "
            f"blocks x {sl} entries ({smem} bytes of shared memory a block)")
    if dev.type != "cuda":
        print(f"{head}; the card's limit not queried on the cpu")
        return None
    m = _limit(dev)(c, smem)
    print(f"{head}; cudaOccupancyMaxActiveClusters: {m} at once")
    return m


def _sweep(label, tab, idx, dev) -> dict:
    """Part 5d: one staged launch alone (a CUDA graph) at cluster counts
    1, 2, 4, ... up to the card's limit, and the geometry's own pick,
    each checked bit-equal; {clusters: ms}."""
    g = staged_geometry(tab.numel(), idx.numel(), _limit(dev))
    top = _limit(dev)(g.cluster, g.smem_bytes)
    counts = sorted({1 << k for k in range(8) if 1 << k <= top}
                    | {top, g.clusters})
    want = tab[idx]
    ms = {}
    ok = True
    for cl in counts:
        def fn(cl=cl):
            return table_gather(tab, idx, staged=True, clusters=cl)
        ok &= torch.equal(fn(), want)
        ms[cl] = graph_ms(fn, counted=(table_gather,))
    print(f"5d staged sweep {label}, clusters of {g.cluster}: " + ", ".join(
        f"{cl}{' (max)' if cl == top else ''}"
        f"{' (rule)' if cl == g.clusters else ''} {t:.5f}"
        for cl, t in ms.items()) + f" ms one launch; bit-equal {ok}")
    return {"ok": ok, "ms": ms, "rule": g.clusters, "max": top}


def profile(argv=None) -> dict:
    """Runs every part and returns ``{"ok": every gather check held,
    "gather": {"p1_global": record, "p1_staged": ..., "p1_staged_pv": ...,
    "p3_*", "huge_*"}, "sweep": {"p3_staged": {"ms": {clusters: ms},
    "rule": n, "max": n, "ok": bool}, ...}}`` with the records of
    ``_gather_record`` (``*_staged_pv`` only where the card places the
    cluster the PV needs; the sweep only on the card)."""
    ap = argparse.ArgumentParser(
        prog="python -m gblastn_tpu_torch.tools.prof_scan_parts",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a small size for a CPU run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sz = SMALL if args.small else FULL
    S, n_scan, T, W = sz.S, sz.n_scan, sz.table, sz.lut_w
    npv = T // 32
    print(f"device: {device_label(dev)}")
    d = reference_draws(sz)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    base = t(np.random.default_rng(0).integers(0, 4, S, dtype=np.int8))

    def timer(fn, label, denom, unit="Gelem/s"):
        return loop_timer(fn, label, denom, unit, device=dev, base=base)

    pv, lut_off = t(d["pv"]), t(d["lut_off"])
    w32 = t(d["packed"].reshape(-1, 4).astype(np.int64)
            @ np.array([1 << 24, 1 << 16, 1 << 8, 1], np.int64))
    pos = torch.arange(n_scan, dtype=torch.int64, device=dev) * sz.step

    # 1. random gathers: n_scan probes into the PV and the offsets
    idx, idx2 = t(d["idx"]), t(d["idx2"])
    idx64, pv64 = idx.long(), pv.long()
    timer(lambda x: pv[(idx + x[:n_scan].int()) & (npv - 1)].sum(),
          f"1a gather {n_scan} from {_size(4 * npv)} int32", n_scan)
    timer(lambda x: pv64[(idx64 + x[:n_scan].long()) & (npv - 1)].sum(),
          f"1a gather {n_scan} from {_size(8 * npv)} int64", n_scan)
    timer(lambda x: lut_off[(idx2 + x[:n_scan].int()) & (T - 1)].sum(),
          f"1b gather {n_scan} from {_size(4 * T)}", n_scan)
    nk = min(16384, n_scan)
    timer(lambda x: lut_off[(idx2[:nk] + x[:nk].int()) & (T - 1)].sum(),
          f"1c gather {nk} from {_size(4 * T)}", nk)
    if dev.type == "cuda":      # the gathers alone, for K3's table type
        print(f"1a one gather alone (CUDA graph of 100), {n_scan} probes: "
              f"{_size(4 * npv)} int32 {graph_ms(lambda: pv[idx]):.5f} ms, "
              f"{_size(8 * npv)} int64 "
              f"{graph_ms(lambda: pv64[idx64]):.5f} ms")
    else:
        print(f"1a one gather alone, {n_scan} probes: not measured on the "
              "cpu")

    # 2. the PV build, as _presence_hits does it inside every scan
    shifts = torch.arange(32, dtype=torch.int64, device=dev)

    def pv_build(x):
        present = lut_off[1:] > lut_off[:-1]
        bits = present.view(npv, 32).to(torch.int64)
        return (bits << shifts).sum(dim=1).sum() + x[0]
    timer(pv_build, f"2  PV build {T} offsets", T)

    # 3. word compute
    valid = torch.ones(S, dtype=torch.bool, device=dev)

    def words_strided(s2):          # scan_block's loop
        words = torch.zeros(n_scan, dtype=torch.int64, device=dev)
        valid_word = torch.ones(n_scan, dtype=torch.bool, device=dev)
        for j in range(W):
            words += s2[pos + j].to(torch.int64) << (2 * (W - 1 - j))
            valid_word &= valid[pos + j]
        return torch.where(valid_word, words, 0).sum()
    timer(words_strided, "3a words strided (scan_block)", S, "Gbase/s")

    n_w = S // 16
    word_mask = 0xFFFFFFFF          # the reference's uint32 wrap

    def words_packed(x):
        w32x = w32 ^ x[:n_w].long()
        hi = w32x[pos >> 4]
        lo = w32x[torch.clamp((pos >> 4) + 1, max=n_w - 1)]
        sh = 2 * (pos & 15)
        word = (((hi << sh) | torch.where(sh == 0, 0, lo >> (32 - sh)))
                & word_mask) >> (32 - 2 * W)
        return word.sum()
    timer(words_packed, "3b words packed 2-gather (int64)", S, "Gbase/s")

    def words_allpos(x):
        w32x = w32 ^ x[:n_w].long()
        lo = torch.cat([w32x[1:], w32x[:1]])
        phases = []
        for k in range(16):
            sh = 2 * k
            v = ((w32x << sh) | (lo >> (32 - sh) if sh else 0)) & word_mask
            phases.append(v >> (32 - 2 * W))
        allw = torch.stack(phases, dim=1).reshape(-1)
        return allw[pos].sum()
    timer(words_allpos, "3c words all-pos + subsample (int64)", S,
          "Gbase/s")

    # 4. compaction, as the port does it
    def comp(x):
        hit = torch.nonzero((x[:n_scan] & 15) == 0).squeeze(1)
        return hit.sum() + hit.numel()
    timer(comp, f"4  torch.nonzero {n_scan} (x&15==0)", n_scan)

    # 5. P1-P3: the table gather, each shape in both modes; the staged
    # mode on the narrow PV (one block's shared memory) and on the PV
    # itself (a cluster's)
    tab = t(d["tab"])
    ns = sz.staged
    tab_s = tab[:ns]
    ok = True
    gather, sweep = {}, {}
    fits = {}
    for tb in (tab_s, tab):
        fits[tb.numel()] = _geometry_line(tb, dev) != 0
    for key, name, lab in (
            ("gidx", "p1", "(8, 128)"), ("bigidx", "p3", str(sz.gn)),
            ("hugeidx", "huge", str(sz.huge))):
        probes = t(d[key])
        want = d["tab"][d[key]]
        p1 = " [P1]" if key == "gidx" else " [P3]" if key == "bigidx" else ""
        gather[f"{name}_global"] = _gather_record(
            f"5{'a' if key == 'gidx' else 'c'} table_gather global "
            f"{lab}{p1}", tab, probes, False, want, dev)
        gather[f"{name}_staged"] = _gather_record(
            f"5s table_gather staged {_size(4 * ns)} {lab}", tab_s,
            probes & (ns - 1), True, d["tab"][:ns][d[key] & (ns - 1)], dev)
        label = f"5s table_gather staged {_size(4 * npv)} {lab}{p1}"
        if fits[npv]:
            gather[f"{name}_staged_pv"] = _gather_record(
                label, tab, probes, True, want, dev)
        else:       # the card places no cluster of the size it needs
            try:
                table_gather(tab, probes, staged=True)
            except RuntimeError as e:
                print(f"{label}: refused (RuntimeError: {e})")
            else:
                print(f"{label}: NOT refused")
                ok = False
        if key != "gidx":
            _time_gathers(probes.numel(), tab, probes, tab_s, timer)
            if dev.type == "cuda":
                for tb, pr, tag in ((tab_s, probes & (ns - 1), "staged"),
                                    (tab, probes, "staged_pv")):
                    if fits[tb.numel()]:
                        sweep[f"{name}_{tag}"] = _sweep(
                            f"{_size(4 * tb.numel())} {lab}", tb, pr, dev)
            else:
                print(f"5d staged sweep {lab}: not measured on the cpu")
            continue
        out = table_gather(tab, probes)
        ok2 = torch.equal(out, torch.take(tab, probes.long()))
        print(f"5b table_gather global (8, 128) vs torch.take [P2]: OK "
              f"correct={ok2}")
        ok &= ok2
        over = torch.zeros(MAX_STAGED_ENTRIES + 1, dtype=torch.int32,
                           device=dev)
        try:
            table_gather(over, probes, staged=True)
        except ValueError as e:
            print(f"5s table_gather staged {over.numel()} entries: refused "
                  f"(ValueError: {e})")
        else:
            print(f"5s table_gather staged {over.numel()} entries: NOT "
                  "refused")
            ok = False
        del over
    ok &= all(r["ok"] for r in gather.values())
    ok &= all(r["ok"] for r in sweep.values())
    print(f"# table_gather bit-equal in every check: {ok}")
    return {"ok": ok, "gather": gather, "sweep": sweep}


def main(argv=None) -> int:
    return 0 if profile(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
