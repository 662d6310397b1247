"""Host orchestration of the device seeding stage (one-hit and two-hit
seeding, contiguous and discontiguous templates).

The port's counterpart of ``gblastn_tpu/engine/seeding.py`` on the main
path: scan + mini-extension on the device (ops.seeding; a discontiguous
template's seeds skip the mini-extension, and with two templates both
seed sets, template 1 first, go through one K1; indexed megablast walks
the query against the database index instead, and the database's
soft-mask intervals keep seeds off masked words), K1 on every survivor
(ops.ungapped), then the device finish (``_dev_replay_pack`` without its
caps and fallbacks): with two-hit seeding the double-word probe RR where
the ``rr_zero`` rule allows it, the approximate-ungapped gate G and the
diagonal replay R (ops.replay), reproducing
``s_BlastnDiagTableExtendInitialHit`` (NCBI na_ungapped.c:612-755) with
scan range 0, and one device-to-host fetch of the saved seeds only.

Two-hit seeding with a scan range (``-off_diagonal_range``) probes the
neighbour diagonals, so its replay runs on the host in scan order
(``two_hit_scan_range_filter``, as in the JAX package): the card runs
the scan, K1, RR and G, one fetch brings every seed's rows, and the host
finish ``_finish_init_hits`` replays them (``gated``: G's demotion is
already in the rows), then gives the seeds the off-diagonal probe saved
below the cutoff their approximate data. The streamed path
(engine.stream) runs the same device finish over its blocks' rows, and
the same host finish where it has a scan range.

Sizes are exact, so the JAX package's capacity buckets and retries have
no counterpart here. K1 has no window and returns exact extensions, so
there is no phase-0 clamp and no phase-2 escalation either; G has no
clamp, so every seed resolves and nothing falls back; R has no cap. All
of these were exact in the JAX package, so removing them changes no
result. Subject coordinates are int64 from the scan to the fetch, so a
database of any size the card holds is searched as one resident block
(R reads int32 subject-local coordinates while every subject is shorter
than ``NARROW_SUBJECT``). ``_finish_init_hits`` is the host finish: the
off-diagonal replay runs it (on the streamed path too), and the tests and
chip_smoke.py hold the device finish to it, with its host twins
``compute_right_runs``, ``one_hit_diag_filter``, ``two_hit_diag_filter``
and ``two_hit_scan_range_filter``. The JAX package's
``two_hit_admission`` (a superset filter that shrinks K1's TPU lane
work) has no counterpart: it changes no result.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gblastn_tpu_torch.utils.profiling import slog
from gblastn_tpu_torch.engine.resident import ResidentDB
from gblastn_tpu_torch.ops.replay import (
    FLAG_NEED,
    FLAG_RANGE as GATE_FLAG_RANGE,
    approx_gate,
    check_gate_flags,
    check_key_flag,
    diag_replay,
    key_range_flag,
    replay_keys,
    right_run,
)
from gblastn_tpu_torch.ops.seeding import scan_span, seeding_scan_mini
from gblastn_tpu_torch.ops.ungapped import (
    FLAG_RANGE,
    check_flags,
    ungapped_extend_window,
)


@dataclass
class InitHits:
    """Saved initial hits (BlastInitHitList analog), sorted by score order."""

    q_off: np.ndarray      # seed offsets (mini-extended starts)
    s_off: np.ndarray
    q_start: np.ndarray    # ungapped extension data
    s_start: np.ndarray
    length: np.ndarray
    score: np.ndarray
    context: np.ndarray    # query context per hit
    oid: np.ndarray        # subject id per hit

    def __len__(self) -> int:
        return len(self.q_off)


@dataclass
class SeedingDeviceData:
    """One batch's device inputs beside the resident database (a
    streamed batch has none: engine.stream gives each block its own)."""

    resident: ResidentDB | None
    query_packed: torch.Tensor   # uint8[Q] K1 query bytes (mask | deg << 4)
    query_nib: torch.Tensor      # int64[Q/8] 4na-mask nibbles
    lut_offsets: torch.Tensor    # int32[4^w + 1] CSR offsets
    lut_positions: torch.Tensor  # int32[P] CSR query offsets
    table64: torch.Tensor        # int32[72] K1 score table
    qbytes: torch.Tensor         # uint8[Q-3] packed query bytes (G reads)
    table256: torch.Tensor       # int32[256] G's packed XOR score table
    ctx_tables: torch.Tensor     # int32[3, n_ctx] word cutoff, reduced
                                 # cutoff, x_drop per context
    window: int = 0              # two-hit window (0: one-hit)
    lut2_offsets: torch.Tensor | None = None    # the second template's
    lut2_positions: torch.Tensor | None = None  # CSR (coding_and_optimal)
    query: torch.Tensor | None = None       # uint8[Q] BLASTNA codes (the
                                            # indexed scan reads them)
    q_allowed: torch.Tensor | None = None   # bool[Q]: indexed megablast;
                                            # lut_* then hold the database
                                            # index's CSR
    mask_starts: torch.Tensor | None = None  # int64[M] database soft-mask
    mask_ends: torch.Tensor | None = None    # intervals (sorted)
    finish_kw: dict | None = None   # the host finish's own inputs
                                    # (word_cutoffs, subject_starts,
                                    # approx_ctx): the off-diagonal
                                    # replay and the streamed path run it


# R reads int32 subject-local coordinates where every subject is
# shorter than this (its seeds' and extensions' ends then fit), else int64
NARROW_SUBJECT = (1 << 31) - (1 << 20)


def sort_by_score_order(
    score: np.ndarray, s_start: np.ndarray, length: np.ndarray,
    q_start: np.ndarray,
) -> np.ndarray:
    """Index order of score_compare_match (blast_extend.c:279)."""
    return np.lexsort((q_start, -length, s_start, -score))


def _native_diag_order(q_off, s_off, oid, diag_mask=0):
    """Replay key order via native comparator sort (== np.lexsort
    ((q_off, s_off, diag, oid)) exactly); None if the lib is absent."""
    from gblastn_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    n = len(q_off)
    q32 = np.ascontiguousarray(q_off, np.int32)
    s32 = np.ascontiguousarray(s_off, np.int32)
    o32 = np.ascontiguousarray(oid, np.int32)
    order = np.empty(n, np.int64)
    rc = lib.gblastn_diag_order(
        q32.ctypes.data, s32.ctypes.data, o32.ctypes.data,
        n, diag_mask, order.ctypes.data,
    )
    if rc != 0:   # allocation failure: fall back to np.lexsort
        return None
    return order


def _native_diag_filter(
    q_off, s_off, oid, order, word_size, window,
    ung_s_start, ung_length, ung_score, cutoff, right_run,
    diag_mask=0,
):
    """Run the native replay loop; None if the native lib is absent."""
    from gblastn_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    def c32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    n = len(q_off)
    saved = np.zeros(n, dtype=np.uint8)
    q32, s32, o32 = c32(q_off), c32(s_off), c32(oid)
    us32, ul32, sc32, cu32 = (
        c32(ung_s_start), c32(ung_length), c32(ung_score), c32(cutoff)
    )
    ord64 = np.ascontiguousarray(order, dtype=np.int64)
    rr32 = c32(right_run) if right_run is not None else None
    lib.gblastn_diag_filter(
        q32.ctypes.data, s32.ctypes.data, o32.ctypes.data,
        ord64.ctypes.data, ctypes.c_int64(n),
        ctypes.c_int64(word_size), ctypes.c_int64(window),
        ctypes.c_int64(diag_mask),
        us32.ctypes.data, ul32.ctypes.data,
        sc32.ctypes.data, cu32.ctypes.data,
        rr32.ctypes.data if rr32 is not None else None,
        saved.ctypes.data,
    )
    return saved.astype(bool)


def diag_table_mask(concat_qlen: int, window_size: int) -> int:
    """Diagonal-key mask replicating the reference's container choice:
    blastn-family searches with concatenated query length > 8000 use the
    exact eDiagHash container (mask 0 here = exact diagonals); smaller
    ones use the pow2 eDiagArray whose masked indexing ALIASES diagonals
    that differ by diag_array_length (BlastExtendWordNew,
    blast_extend.c:57 + kQueryLenForHashTable, blast_parameters.c:174)."""
    if concat_qlen > 8000:
        return 0
    L = 1
    while L < concat_qlen + window_size:
        L <<= 1
    return L - 1


def one_hit_diag_filter(
    q_off: np.ndarray,
    s_off: np.ndarray,
    oid: np.ndarray,
    word_size: int,
    ung_s_start: np.ndarray,
    ung_length: np.ndarray,
    ung_score: np.ndarray,
    cutoff: np.ndarray,
    use_native: bool = True,
    diag_mask: int = 0,
) -> np.ndarray:
    """Sequential per-diagonal replay; returns boolean 'saved' mask.

    Diagonal state is keyed on (oid, diag). Reference semantics
    (na_ungapped.c:612):
      - skip seeds starting inside the explored area (s_off < last_hit);
      - accepted seeds with ungapped score >= cutoff are saved and push
        last_hit to the ungapped end; failed ones push it to seed end.

    Runs natively (native/diagfilter.cpp) when available; the Python
    loop below is the parity oracle.
    """
    n = len(q_off)
    saved = np.zeros(n, dtype=bool)
    if n == 0:
        return saved
    if use_native:
        order = _native_diag_order(q_off, s_off, oid, diag_mask)
        if order is not None:
            native = _native_diag_filter(
                q_off, s_off, oid, order, word_size, 0,
                ung_s_start, ung_length, ung_score, cutoff, None,
                diag_mask,
            )
            if native is not None:
                return native
    diag = s_off.astype(np.int64) - q_off.astype(np.int64)
    if diag_mask:
        diag = diag & diag_mask
    # q tiebreak: aliased diagonals can carry two hits at one subject
    # position; the scan emits them in ascending-q chain order
    order = np.lexsort((q_off, s_off, diag, oid))
    last_key = None
    last_hit = 0
    for i in order:
        key = (int(oid[i]), int(diag[i]))
        if key != last_key:
            last_key = key
            last_hit = 0
        s = int(s_off[i])
        if s < last_hit:
            continue
        if ung_score[i] >= cutoff[i]:
            saved[i] = True
            last_hit = int(ung_s_start[i]) + int(ung_length[i])
        else:
            last_hit = s + word_size
    return saved


def compute_right_runs(
    query: np.ndarray,       # uint8[Q] BLASTNA with sentinels
    subject2: np.ndarray,    # int8[S] 2-bit codes
    valid: np.ndarray,       # bool[S]
    q_off: np.ndarray,
    s_off: np.ndarray,
    word_size: int,
) -> np.ndarray:
    """Exact-match run length to the right of each seed's word end,
    capped at word_size (the double-word probe of s_TypeOfWord,
    na_ungapped.c:559-586; equality there is checked through lookup
    membership, which reduces to base equality for unmasked seeds).
    Sentinels in the query (code 15) and subject padding stop the run,
    which enforces the reference's context/range bounds ext_max."""
    n = len(q_off)
    if n == 0:
        return np.zeros(0, np.int32)
    W = word_size
    k = np.arange(W)
    qi = np.minimum(q_off.astype(np.int64)[:, None] + W + k,
                    len(query) - 1)
    si = np.minimum(s_off.astype(np.int64)[:, None] + W + k,
                    len(subject2) - 1)
    match = (
        (query[qi] == subject2[si].astype(np.uint8))
        & (query[qi] < 4)
        & valid[si]
        & (q_off[:, None] + W + k < len(query))
        & (s_off[:, None] + W + k < len(subject2))
    )
    return np.cumprod(match, axis=1).sum(axis=1).astype(np.int32)


def two_hit_diag_filter(
    q_off: np.ndarray,
    s_off: np.ndarray,
    oid: np.ndarray,
    word_size: int,
    window: int,
    ung_s_start: np.ndarray,
    ung_length: np.ndarray,
    ung_score: np.ndarray,
    cutoff: np.ndarray,
    right_run: np.ndarray,
    use_native: bool = True,
    diag_mask: int = 0,
) -> np.ndarray:
    """Two-hit per-diagonal replay for window_size > 0
    (s_BlastnDiagTableExtendInitialHit, na_ungapped.c:612-755 with the
    default scan_range 0, so the off-diagonal probe is skipped).

    Per (oid, diag) state: last_hit = right end of the last hit seen,
    hit_saved flag. A hit is extended when it is the second hit within
    ``window`` of a pending first hit, or when it is itself a double
    word (exact run >= 2 * word_size, via ``right_run``).
    """
    n = len(q_off)
    saved = np.zeros(n, dtype=bool)
    if n == 0:
        return saved
    if use_native:
        order = _native_diag_order(q_off, s_off, oid, diag_mask)
        if order is not None:
            native = _native_diag_filter(
                q_off, s_off, oid, order, word_size, window,
                ung_s_start, ung_length, ung_score, cutoff, right_run,
                diag_mask,
            )
            if native is not None:
                return native
    diag = s_off.astype(np.int64) - q_off.astype(np.int64)
    if diag_mask:
        diag = diag & diag_mask
    order = np.lexsort((q_off, s_off, diag, oid))
    last_key = None
    last_hit = 0
    flag = 0
    for i in order:
        key = (int(oid[i]), int(diag[i]))
        if key != last_key:
            last_key = key
            # virgin diagonal: last_hit = -window (s_BlastDiagClear,
            # blast_extend.c:108), so the first hit always takes the
            # first-hit branch even when s_end <= window
            last_hit = -window
            flag = 0
        s = int(s_off[i])
        s_end = s + word_size
        if s < last_hit:
            continue
        if flag or s_end > last_hit + window:
            # first hit (or follows a saved hit): record it unless the
            # word itself extends to a double word
            ext = int(right_run[i])
            s_end += ext
            hit_ready = ext >= word_size
        else:
            hit_ready = True
        if hit_ready:
            if ung_score[i] >= cutoff[i]:
                saved[i] = True
                s_end = int(ung_s_start[i]) + int(ung_length[i])
            else:
                hit_ready = False
        last_hit = s_end
        flag = 1 if hit_ready else 0
    return saved


def two_hit_scan_range_filter(
    q_off: np.ndarray,
    s_off: np.ndarray,
    oid: np.ndarray,
    word_size: int,
    window: int,
    scan_range: int,
    ung_s_start: np.ndarray,
    ung_length: np.ndarray,
    ung_score: np.ndarray,
    cutoff: np.ndarray,
    right_run: np.ndarray,
    diag_mask: int = 0,
) -> np.ndarray:
    """Two-hit replay with the off-diagonal probe
    (-off_diagonal_range > 0): s_BlastnDiagTableExtendInitialHit
    (na_ungapped.c:612) with Delta = min(scan_range, window - word).

    Unlike the per-diagonal replay, neighbour diagonals interact, so
    hits process in scan order (oid, then s_off, then q_off) over an
    exact per-(oid, diag) state map (the eDiagHash container semantics;
    with ``diag_mask`` the neighbour keys alias as the eDiagArray's
    do). A virgin diagonal starts at last_hit = -window. The state
    keeps the pending hit's length, and a probe finds a neighbour's
    pending (unsaved) hit whose span qualifies; ``right_run`` carries
    the double-word probe (s_TypeOfWord), and a double word (a run of
    word bases or more) skips the probe. A seed the probe finds is saved
    even below its cutoff (``off_found``, na_ungapped.c:732). The loop
    reads Python lists (the JAX package's loop over numpy scalars, the
    same machine)."""
    n = len(q_off)
    saved = np.zeros(n, dtype=bool)
    if n == 0:
        return saved
    order = np.lexsort((q_off, s_off, oid)).tolist()
    delta_max = max(min(scan_range, window - word_size), 0)
    q_l, s_l, o_l, st_l, ln_l, sc_l, cu_l, rr_l = (
        np.asarray(a).tolist() for a in (
            q_off, s_off, oid, ung_s_start, ung_length, ung_score, cutoff,
            right_run))
    virgin = (-window, 0, 0)
    # (oid, diag) -> (last_hit, flag, pending hit length)
    state: dict[tuple[int, int], tuple[int, int, int]] = {}
    get = state.get
    deltas = range(1, delta_max + 1)
    keep = []
    for i in order:
        o = o_l[i]
        s = s_l[i]
        diag = s - q_l[i]
        if diag_mask:
            diag &= diag_mask
        last_hit, flag, _hl = get((o, diag), virgin)
        if s < last_hit:
            continue
        s_end = s + word_size
        hit_ready = 1
        off_found = False
        if flag or s_end > last_hit + window:
            ext = rr_l[i]
            s_end += ext
            if ext < word_size:
                # a single word: probe the neighbour diagonals for a
                # pending hit whose span qualifies
                s_a = s + word_size - window
                s_b = s_end - 2 * word_size
                for delta in deltas:
                    up = diag + delta
                    dn = diag - delta
                    if diag_mask:
                        up &= diag_mask
                        dn &= diag_mask
                    st = get((o, up))
                    if (st and st[2] and st[0] - delta >= s_a
                            and st[0] - st[2] <= s_b):
                        off_found = True
                        break
                    st = get((o, dn))
                    if (st and st[2] and st[0] >= s_a
                            and st[0] - st[2] + delta <= s_b):
                        off_found = True
                        break
                if not off_found:
                    hit_ready = 0
        if hit_ready:
            if off_found or sc_l[i] >= cu_l[i]:
                keep.append(i)
                s_end = st_l[i] + ln_l[i]
            else:
                hit_ready = 0
        state[(o, diag)] = (s_end, hit_ready,
                            0 if hit_ready else s_end - s)
    saved[keep] = True
    return saved


def scan_parts(
    dev: SeedingDeviceData,
    *,
    word_size: int,
    lut_word: int,
    scan_step: int,
    context_offsets: np.ndarray,    # int32[n_ctx+1]
    x_dropoffs: np.ndarray,         # int32[n_ctx] per-context raw X-drop
    disc_offsets: tuple[int, ...] | None = None,   # discontiguous template
    disc_offsets2: tuple[int, ...] | None = None,  # the second one, with
                                                   # dev.lut2_*
    scan_range: int = 0,            # the finish's (run_seeding_steps)
    first: int = 0,                 # the first scan position
    n_scan: int | None = None,      # scan positions (default: to the end)
) -> list[tuple]:
    """Scan + mini-extension on the device, one part a template:
    ``seeding_scan_mini``'s (qs, ss, ctx, x_drop, max_l, max_r, n_raw)
    over the positions ``first + k * scan_step`` (k < ``n_scan``; by
    default every position of the resident subject), template 1 first.
    With ``dev.q_allowed`` the raw seeds come from the database index
    (indexed megablast); ``dev.mask_starts`` / ``mask_ends`` keep seeds
    off the database's soft-masked words."""
    res = dev.resident
    n_ctx = len(x_dropoffs)
    if n_scan is None:
        n_scan = max((res.length - first - scan_span(lut_word, disc_offsets))
                     // scan_step + 1, 1)
    device = res.device
    ctx_off = torch.from_numpy(
        np.asarray(context_offsets[: n_ctx + 1], np.int64)).to(device)
    xdrop = torch.from_numpy(np.asarray(x_dropoffs, np.int32)).to(device)
    tables = [(dev.lut_offsets, dev.lut_positions, disc_offsets)]
    if disc_offsets2:
        tables.append((dev.lut2_offsets, dev.lut2_positions, disc_offsets2))
    return [seeding_scan_mini(
        res.subject2, res.valid, offsets, positions, dev.query_nib,
        res.subject_w, ctx_off, xdrop, res.starts, res.ends,
        query_len=int(dev.query_packed.shape[0]), scan_step=scan_step,
        lut_word=lut_word, word_size=word_size, n_scan=n_scan,
        disc_offsets=disc, mask_starts=dev.mask_starts,
        mask_ends=dev.mask_ends, query=dev.query, q_allowed=dev.q_allowed,
        first=first)
        for offsets, positions, disc in tables]


def join_parts(dev: SeedingDeviceData, parts: list[tuple]):
    """(ctx, k1_args, n_raw) of ``scan_parts``' parts: the survivors'
    contexts, the argument tuple of ``ungapped_extend_window`` for them
    (int64 subject offsets) and the raw seed count. With two templates
    their seeds are concatenated, template 1 first, as
    ``merge_two_template_raw`` merges them in the JAX package (the
    replay's stable order then breaks ties by index as the host does)."""
    if len(parts) == 1:
        qs, ss, ctx, xd, max_l, max_r, n_raw = parts[0]
    else:
        qs, ss, ctx, xd, max_l, max_r = (torch.cat(c) for c in zip(
            *(p[:6] for p in parts)))
        n_raw = sum(p[6] for p in parts)
    k1_args = (dev.query_packed, dev.resident.subject2, dev.table64,
               qs.to(torch.int32), ss, xd, max_l, max_r)
    return ctx, k1_args, n_raw


def ungapped_inputs(dev: SeedingDeviceData, **scan_kw):
    """Scan + mini-extension on the device (``scan_parts``, whose
    keywords these are), joined (``join_parts``): (ctx, k1_args,
    n_raw)."""
    return join_parts(dev, scan_parts(dev, **scan_kw))


def probes_double_words(dev: SeedingDeviceData, scan_kw: dict) -> bool:
    """Whether the finish runs RR: two-hit seeding with a word longer
    than the lookup word of a contiguous template. Otherwise the runs are
    0 by definition (the ``rr_zero`` rule: s_TypeOfWord makes no probe
    when word_length == lut_word_length, na_ungapped.c:512, and a
    discontiguous template's word is its whole window)."""
    return (dev.window > 0 and scan_kw["lut_word"] < scan_kw["word_size"]
            and not scan_kw.get("disc_offsets"))


def drive(gen):
    """Run a generator of the ``*_steps`` form to its end; its return
    value (StopIteration.value)."""
    try:
        while True:
            next(gen)
    except StopIteration as e:
        return e.value


def run_seeding(
    dev: SeedingDeviceData,
    **scan_kw,                      # scan_parts keywords
) -> InitHits:
    """Seeding pass over the resident database: scan + mini and K1 on
    the device, the device finish (RR where it probes, G, R; one-hit or
    two-hit by ``dev.window``), one fetch of the saved seeds. With a
    window and ``scan_range`` > 0 (-off_diagonal_range) the card stops
    after G, one fetch brings every seed's rows and the host replays
    them (``host_finish``). A seed that K1 or G flagged out of range, or
    a key field past the bound the sort packed it for
    (``key_range_flag``), raises ValueError at the fetch, before a row is
    used. ``run_seeding_steps`` driven to its end."""
    return drive(run_seeding_steps(dev, **scan_kw))


def run_seeding_steps(dev: SeedingDeviceData, **scan_kw):
    """Generator form of ``run_seeding``: yields exactly once, after the
    device finish is launched and before its one wait (the ``nonzero``
    of R's saved seeds, or the off-diagonal path's fetch), so a caller
    can run host work of another batch while the card computes
    (engine.pipeline). Only the scan waits before the yield (it sizes its
    seed arrays). The InitHits arrive as StopIteration.value."""
    offdiag = dev.window > 0 and scan_kw.get("scan_range", 0) > 0
    with slog.time("device.seeding.pipeline"):
        ctx, k1_args, n_raw = ungapped_inputs(dev, **scan_kw)
        ung = ungapped_extend_window(*k1_args)
    n = int(k1_args[3].numel())
    slog.diagnostics.lookup_hits += n_raw
    slog.diagnostics.init_extends += n
    if n:
        with slog.time("device.seeding.finish"):
            if offdiag:
                rows, head = gated_rows(dev, k1_args, ctx, ung, scan_kw)
            else:
                rows, head, saved = device_finish(dev, k1_args, ctx, ung,
                                                  scan_kw)
    yield                                           # launched, not fetched
    if n == 0:
        z = np.zeros(0, dtype=np.int32)
        return InitHits(z, z, z, z, z, z, z, z)
    if offdiag:
        with slog.time("device.seeding.fetch"):
            out = torch.cat([head, rows.reshape(-1)]).cpu().numpy()
        slog.add_value("seeding.fetch_bytes", out.nbytes)
        check_flags(out[0:1])
        check_gate_flags(out[1:2])
        return host_finish(dev, out[2:].reshape(rows.shape[0], -1), scan_kw)
    return fetch_saved(rows, head, saved)


def fetch_saved(rows: torch.Tensor, head: torch.Tensor,
                saved: torch.Tensor) -> InitHits:
    """The device finish's one wait and fetch: ``device_finish``'s rows,
    head and R's saved flags to the InitHits of the saved seeds in score
    order. A range flag in the head raises ValueError before a row is
    used."""
    with slog.time("device.seeding.finish"):
        keep = torch.nonzero(saved).squeeze(1)      # the one wait
    with slog.time("device.seeding.fetch"):
        out = torch.cat([head, rows[:, keep].reshape(-1)]).cpu().numpy()
    slog.add_value("seeding.fetch_bytes", out.nbytes)
    slog.add_value("seeding.gate_need", int(out[0]))
    check_flags(out[1:2])
    check_gate_flags(out[2:3])
    check_key_flag(out[3:4])
    q_np, c_np, uq, ulen, usc, oid, *halves = out[4:].reshape(10, -1)
    s_np, us = (np.stack(h, 1).view(np.int64)[:, 0]
                for h in (halves[:2], halves[2:]))
    order = sort_by_score_order(usc, us, ulen, uq)
    return InitHits(q_off=q_np[order], s_off=s_np[order],
                    q_start=uq[order], s_start=us[order],
                    length=ulen[order], score=usc[order],
                    context=c_np[order], oid=oid[order])


def host_finish(dev: SeedingDeviceData, rows: np.ndarray,
                scan_kw: dict) -> InitHits:
    """The off-diagonal path's host half: ``gated_rows``' fetched rows
    (int32[9 or 10, n]) through ``_finish_init_hits`` with the window,
    the runs and the scan range, ``gated`` (G demoted them on the card),
    with ``dev.finish_kw``'s cutoffs, subject starts and approximate
    data."""
    q_np, c_np, uq, ulen, usc, *rest = rows
    if len(rest) == 5:
        runs, *halves = rest
    else:
        runs, halves = np.zeros(len(q_np), np.int32), rest
    s_np, us = (np.stack(h, 1).view(np.int64)[:, 0]
                for h in (halves[:2], halves[2:]))
    fkw = dev.finish_kw
    n_ctx = dev.ctx_tables.shape[1]
    return _finish_init_hits(
        q_np, s_np, c_np, uq, us, ulen, usc, fkw["word_cutoffs"],
        fkw["subject_starts"], scan_kw["word_size"],
        concat_qlen=int(scan_kw["context_offsets"][n_ctx]) - 2,
        approx_ctx=fkw["approx_ctx"], window_size=dev.window,
        right_run=runs, scan_range=scan_kw["scan_range"], gated=True)


def gate_inputs(dev: SeedingDeviceData, k1_args, ctx, ung) -> tuple:
    """The arguments of ``approx_gate`` for K1's seeds and outputs
    (``ung``), on their device: the packed query bytes, the resident
    packed subject and subject bounds, the batch's tables, then q_off,
    s_off (int64), ctx, oid (by ``searchsorted`` over the subject starts)
    and K1's q_start, s_start (int64), length and score."""
    res = dev.resident
    ss = k1_args[4]
    oid = torch.searchsorted(res.starts, ss, right=True) - 1
    return (dev.qbytes, res.packed, dev.table256, dev.ctx_tables,
            res.starts, res.ends, k1_args[3], ss, ctx.to(torch.int32),
            oid.to(torch.int32), *ung[:4])


def replay_inputs(dev: SeedingDeviceData, seeds: tuple, rows, *,
                  concat_end: int, bounds: tuple | None = None
                  ) -> tuple[tuple, int, torch.Tensor]:
    """The arguments of ``diag_replay`` (key, order, s_loc, end_loc,
    score, cutoff) for the ``seeds`` (q_off, int64 s_off, int32 ctx and
    oid: ``gate_inputs``' ``g_args[6:10]``) and their extension ``rows``
    (q_start, s_start, length, score) after the gate, its ``key_shift``,
    and the sort's range flag, over the resident database's subjects, or
    over ``bounds`` (the subject starts on the seeds' device and the
    longest subject's length) where there is none: subject-local
    coordinates (int32 where the longest subject is shorter than
    ``NARROW_SUBJECT``, else int64, which R's wide kernels read), the keys
    sorted by ``replay_keys`` with the diagonal mask of the batch's
    concatenated query length and window, and the batch's bounds (subject
    count, longest subject, query buffer), one sort where they fit 63
    bits; ``key_range_flag`` of the seeds against those bounds (an int32
    on the device, nonzero where a field would overwrite the next)."""
    starts, longest = (bounds if bounds is not None
                       else (dev.resident.starts, dev.resident.longest))
    qs, ss, ctx32, oid32 = seeds
    _uq, us, ulen, usc = rows
    base = starts[oid32.long()]
    s_loc = ss - base
    end_loc = us - base + ulen
    if longest < NARROW_SUBJECT:
        s_loc, end_loc = s_loc.to(torch.int32), end_loc.to(torch.int32)
    bounds = dict(n_sub=starts.numel(), s_len=longest,
                  q_len=dev.query_packed.numel())
    key, order, shift = replay_keys(
        qs, s_loc, oid32, diag_table_mask(concat_end - 1, dev.window),
        **bounds)
    return ((key, order, s_loc, end_loc, usc,
             dev.ctx_tables[0][ctx32.long()]), shift,
            key_range_flag(qs, s_loc, oid32, **bounds))


def run_inputs(dev: SeedingDeviceData, k1_args, g_args,
               scan_kw: dict) -> tuple | None:
    """The arguments of ``right_run`` for K1's seeds: the batch's query
    nibbles, the resident subject words and subject ends, then int32
    q_off, s_off and oid (``gate_inputs``'); None where the finish runs
    no RR (``probes_double_words``: the runs are then 0)."""
    if not probes_double_words(dev, scan_kw):
        return None
    res = dev.resident
    return (dev.query_nib, res.subject_w, res.ends, k1_args[3], k1_args[4],
            g_args[9])


def gate_rows(dev: SeedingDeviceData, k1_args, ctx, ung, scan_kw: dict):
    """RR and G over K1's outputs on the seeds' device, for the scan
    keywords ``scan_kw`` (``scan_parts``'); nothing here waits on the
    card. Returns (g_args, runs, rows, head, g_flags): ``gate_inputs``'
    arguments, RR's runs (None where ``run_inputs`` gives no arguments:
    the runs are then 0), the extension rows after G (q_start, s_start,
    length, score), a list of int32 scalars (gated seeds; K1's and G's
    FLAG_RANGE if any seed carries it, else 0) and G's flags (None where
    G did not run). G runs for word sizes of 11 and up, as the reference
    scores approximately first only there."""
    word_size = scan_kw["word_size"]
    concat_end = int(scan_kw["context_offsets"][dev.ctx_tables.shape[1]]) - 1
    g_args = gate_inputs(dev, k1_args, ctx, ung)
    rr_args = run_inputs(dev, k1_args, g_args, scan_kw)
    runs = (None if rr_args is None
            else right_run(*rr_args, word_size=word_size))
    rows = ung[:4]
    n_need = torch.zeros((), dtype=torch.int32, device=ung[4].device)
    head = [n_need, (ung[4] & FLAG_RANGE).amax()]
    g_flags = None
    if word_size >= 11:
        *rows, g_flags = approx_gate(*g_args, word_size=word_size,
                                     concat_end=concat_end, right_run=runs)
        head[0] = (g_flags & FLAG_NEED).sum().to(torch.int32)
        head.append((g_flags & GATE_FLAG_RANGE).amax())
    else:
        head.append(n_need)
    return g_args, runs, rows, head, g_flags


def gated_rows(dev: SeedingDeviceData, k1_args, ctx, ung, scan_kw: dict):
    """The off-diagonal path's device half (``gate_rows``, no sort and
    no R): int32 rows of every seed (q_off, ctx, q_start, length, score,
    RR's runs where it ran, then the low and high words of the int64
    s_off and s_start; the extension after G) and an int32[2] head (K1's
    and G's FLAG_RANGE), for one fetch."""
    g_args, runs, rows, head, _f = gate_rows(dev, k1_args, ctx, ung,
                                             scan_kw)
    return (offdiag_rows(g_args[6], g_args[8], g_args[7], rows, runs),
            torch.stack(head[1:]))


def offdiag_rows(q_off, ctx32, s_off, rows, runs) -> torch.Tensor:
    """int32 rows of every seed for ``host_finish``: q_off, ctx, q_start,
    length, score, RR's runs where they ran, then the low and high words
    of the int64 s_off and s_start (``rows``: the extension after G)."""
    uq, us, ulen, usc = rows
    cols = [q_off, ctx32, uq, ulen, usc]
    if runs is not None:
        cols.append(runs.to(torch.int32))
    return torch.cat([torch.stack(cols), _halves(s_off), _halves(us)])


def device_finish(dev: SeedingDeviceData, k1_args, ctx, ung, scan_kw: dict):
    """RR, G (``gate_rows``), the sort and R over K1's outputs on the
    seeds' device; nothing here waits on the card. Returns (rows, head,
    saved): int32[10, n] rows (q_off, ctx, q_start, length, score, oid,
    then the low and high words of the int64 s_off and s_start; the
    extension after G), an int32[4] head (gated seeds; K1's and G's
    FLAG_RANGE if any seed carries it, else 0; the sort's
    ``key_range_flag``) and R's uint8[n] saved. RR's runs feed G and the
    two-hit R; R is two-hit when ``dev.window`` > 0."""
    concat_end = int(scan_kw["context_offsets"][dev.ctx_tables.shape[1]]) - 1
    g_args, runs, rows, head, _f = gate_rows(dev, k1_args, ctx, ung,
                                             scan_kw)
    return replay_rows(dev, g_args[6:10], rows, runs, head, scan_kw,
                       concat_end=concat_end)


def replay_rows(dev: SeedingDeviceData, seeds: tuple, rows, runs, head,
                scan_kw: dict, *, concat_end: int,
                bounds: tuple | None = None):
    """The sort and R over ``seeds`` (q_off, int64 s_off, int32 ctx and
    oid) and their ``rows`` after G (``replay_inputs``, whose ``bounds``
    these are), with RR's ``runs`` (or None); nothing here waits on the
    card. Returns ``device_finish``'s (rows, head, saved): ``head`` (a
    list of int32 scalars) gains the sort's range flag."""
    r_args, shift, key_flag = replay_inputs(dev, seeds, rows,
                                            concat_end=concat_end,
                                            bounds=bounds)
    saved = diag_replay(*r_args, word_size=scan_kw["word_size"],
                        window=dev.window, right_run=runs, key_shift=shift)
    qs, ss, ctx32, oid32 = seeds
    uq, us, ulen, usc = rows
    rows = torch.cat([torch.stack([qs, ctx32, uq, ulen, usc, oid32]),
                      _halves(ss), _halves(us)])
    return rows, torch.stack(head + [key_flag]), saved


def _halves(t: torch.Tensor) -> torch.Tensor:
    """int32[2, n]: the low and high words of the int64[n] ``t`` (so
    that the fetch stays int32; ``run_seeding`` joins them)."""
    return t.contiguous().view(torch.int32).view(-1, 2).t()


def host_gate(approx_ctx: dict, subject_starts, oid, q_np, s_np, ctx,
              rows: tuple, need: np.ndarray, right_run, word_size: int):
    """G on the host for the seeds ``need`` marks: the approximate walk
    (``engine.approx.compute_approx_info`` over ``approx_ctx``, the whole
    packed database) and, for those it demotes, their approximate
    extension in place of ``rows`` (q_start, s_start, length, score; a
    demoted length reaches the word's end and RR's run). Returns (the
    rows, copied where any changed, and the demoted mask)."""
    from gblastn_tpu_torch.engine.approx import compute_approx_info

    oid = np.asarray(oid, np.int64)
    with slog.time("host.approx_gate"):
        demote, a_sc, a_q, a_s, a_r = compute_approx_info(
            approx_ctx["query"], approx_ctx["concat_end"],
            approx_ctx["packed"],
            np.asarray(subject_starts, np.int64)[oid],
            np.asarray(approx_ctx["subject_ends"], np.int64)[oid],
            np.asarray(q_np, np.int64), np.asarray(s_np, np.int64),
            ctx, approx_ctx["x_dropoffs"], approx_ctx["reduced"],
            approx_ctx["table"], need)
    d = need & demote
    if not d.any():
        return rows, d
    ext = right_run.astype(np.int64) if right_run is not None else 0
    sme = np.asarray(s_np, np.int64) + word_size + ext
    ug_q, ug_s, ug_len, ug_score = (np.asarray(r).copy() for r in rows)
    ug_q[d] = a_q[d]
    ug_s[d] = a_s[d]
    ug_len[d] = np.maximum(sme[d] - a_s[d], a_r[d] - a_q[d] + 1)
    ug_score[d] = a_sc[d]
    return (ug_q, ug_s, ug_len, ug_score), d


def _finish_init_hits(
    q_np, s_np, ctx, ug_q, ug_s, ug_len, ug_score,
    word_cutoffs, subject_starts, word_size,
    concat_qlen: int = 1 << 30,   # > 8000 -> exact (hash) diagonals
    approx_ctx: dict | None = None,   # approximate-ungapped gate data
    window_size: int = 0, right_run=None,   # two-hit window and runs
    scan_range: int = 0,          # -off_diagonal_range
    gated: bool = False,          # the rows carry G's demotion already
) -> InitHits:
    """Host finishing: per-context cutoffs, oid mapping, the first
    approximate pass (unless ``gated``: the device path's rows come from
    G, which demoted them), the one- or two-hit diagonal replay (with
    ``scan_range`` the off-diagonal probe, ``two_hit_scan_range_filter``,
    then the approximate data of the seeds it saved below the cutoff),
    final score ordering.

    The replay runs in subject-local int32 coordinates (diagonal state
    is keyed per (oid, diag), and shifting s_off and ung_s_start by the
    same per-subject constant preserves every comparison). A single
    subject past 2^31 bases would overflow the local cast (wrapped
    seeds lose every hit past 2^31), so there the seeds are additionally
    rebased per (oid, diagonal class): replay state never crosses
    classes, so any per-class shift preserves the machine exactly. A
    class that still spans 2^31 raises OverflowError, as does a rebase
    with ``scan_range`` (its probes cross diagonals); the JAX package's
    rebase (gblastn_tpu/engine/seeding.py::_finish_init_hits)."""
    cutoff = word_cutoffs[ctx].astype(np.int32)

    if len(subject_starts) == 1:
        # single-subject DB: every seed maps to oid 0
        oid = np.zeros(len(s_np), np.int32)
        base = np.int64(subject_starts[0])
    else:
        oid = (
            np.searchsorted(subject_starts, s_np, side="right") - 1
        ).astype(np.int32)
        base = subject_starts[oid].astype(np.int64)
    s_loc64 = np.asarray(s_np).astype(np.int64) - base
    ug_s_loc64 = np.asarray(ug_s).astype(np.int64) - base
    i32_safe = (1 << 31) - (1 << 20)
    rebase_shift = None
    if len(s_loc64) and int(s_loc64.max()) >= i32_safe:
        if window_size > 0 and scan_range > 0:
            raise OverflowError(
                "-off_diagonal_range probes interact across diagonals "
                "and cannot be class-rebased; single subjects >= 2^31 "
                "bases are unsupported with it"
            )
        dmask_r = diag_table_mask(concat_qlen, window_size)
        diag64 = np.asarray(s_np).astype(np.int64) - np.asarray(
            q_np).astype(np.int64)
        if dmask_r:
            diag64 = diag64 & dmask_r
        order_r = np.lexsort((s_loc64, diag64, oid))
        o_s2 = oid[order_r]
        d_s2 = diag64[order_r]
        s_s2 = s_loc64[order_r]
        head2 = np.ones(len(order_r), bool)
        head2[1:] = (o_s2[1:] != o_s2[:-1]) | (d_s2[1:] != d_s2[:-1])
        gmin = np.minimum.reduceat(s_s2, np.flatnonzero(head2))
        shift_sorted = np.repeat(gmin, np.diff(np.append(
            np.flatnonzero(head2), len(order_r))))
        shift = np.empty(len(order_r), np.int64)
        shift[order_r] = shift_sorted
        s_loc64 = s_loc64 - shift
        ug_s_loc64 = ug_s_loc64 - shift
        rebase_shift = shift
        if int(s_loc64.max()) >= i32_safe:
            raise OverflowError(
                "a single diagonal class spans >= 2^31 subject bases; "
                "the replay cannot run in int32"
            )
    s_loc = s_loc64.astype(np.int32)
    ug_s_loc = ug_s_loc64.astype(np.int32)
    q32 = q_np.astype(np.int32)
    len32 = ug_len.astype(np.int32)
    score32 = ug_score.astype(np.int32)

    # the reference scores ungapped extensions APPROXIMATELY first for
    # word lengths >= 11 (s_NuclUngappedExtend, na_ungapped.c:263) and
    # only rescored exactly above the reduced cutoff; a seed whose
    # byte-quantized score stays below it keeps the low approximate
    # score and fails the cutoff even when its exact score passes.
    if approx_ctx is not None and word_size >= 11 and not gated:
        # only cutoff-passing seeds can be demoted (failed seeds push
        # last_hit from the seed end either way); below-cutoff seeds
        # saved by the off-diagonal probe get their approximate data
        # after the replay
        need = score32 >= cutoff
        if need.any():
            (ug_q, ug_s, ug_len, ug_score), d = host_gate(
                approx_ctx, subject_starts, oid, q_np, s_np, ctx,
                (ug_q, ug_s, ug_len, ug_score), need, right_run, word_size)
            if d.any():
                ug_s_loc64b = ug_s.astype(np.int64) - base
                if rebase_shift is not None:
                    ug_s_loc64b = ug_s_loc64b - rebase_shift
                ug_s_loc = ug_s_loc64b.astype(np.int32)
                len32 = ug_len.astype(np.int32)
                score32 = ug_score.astype(np.int32)

    dmask = diag_table_mask(concat_qlen, window_size)
    with slog.time("host.diag_filter"):
        if window_size > 0 and scan_range > 0:
            saved = two_hit_scan_range_filter(
                q32, s_loc, oid, word_size, window_size, scan_range,
                ug_s_loc, len32, score32, cutoff,
                right_run if right_run is not None
                else np.zeros(len(q_np), np.int32),
                diag_mask=dmask,
            )
        elif window_size > 0:
            saved = two_hit_diag_filter(
                q32, s_loc, oid, word_size, window_size,
                ug_s_loc, len32, score32, cutoff,
                right_run if right_run is not None
                else np.zeros(len(q_np), np.int32),
                diag_mask=dmask,
            )
        else:
            saved = one_hit_diag_filter(
                q32, s_loc, oid, word_size, ug_s_loc, len32, score32,
                cutoff, diag_mask=dmask,
            )
    if (approx_ctx is not None and word_size >= 11
            and window_size > 0 and scan_range > 0):
        # the off-diagonal probe saves below-cutoff seeds with the
        # reference's ungapped data: approximate unless the byte score
        # reached the reduced cutoff (na_ungapped.c:732); ``score32`` is
        # the score after the first demotion
        sub2 = saved & (score32 < cutoff)
        if sub2.any():
            (ug_q, ug_s, ug_len, ug_score), _d = host_gate(
                approx_ctx, subject_starts, oid, q_np, s_np, ctx,
                (ug_q, ug_s, ug_len, ug_score), sub2, right_run, word_size)
    keep = np.nonzero(saved)[0]
    order = sort_by_score_order(
        ug_score[keep], ug_s[keep], ug_len[keep], ug_q[keep]
    )
    keep = keep[order]
    return InitHits(
        q_off=q_np[keep],
        s_off=s_np[keep],
        q_start=ug_q[keep],
        s_start=ug_s[keep],
        length=ug_len[keep],
        score=ug_score[keep],
        context=ctx[keep],
        oid=oid[keep],
    )
