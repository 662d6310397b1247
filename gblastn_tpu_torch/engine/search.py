"""End-to-end megablast and blastn search on one device, in PyTorch.

The port's counterpart of ``gblastn_tpu/engine/search.py``: the same
host setup (query block, masks, the repeat filter's nested search, lookup
table or the two tables of a discontiguous template pair, derived
parameters), then the resident seeding path on the chosen device (scan,
mini-extension, K1 and the device finish; engine.seeding), the device
banded-DP filter (K2) in front of the host gapped prelim when a batch has
enough candidates, hitlist collection, traceback and ranking; queries
longer than the task's chunk are split and stitched (engine.split), and
``prelim_search_steps`` is the generator form that the pipelined mode
interleaves (engine.pipeline). The port covers megablast, blastn,
blastn-short, vecscreen and dc-megablast (every template), with one-hit
or two-hit seeding (``window_size``, with or without
``off_diagonal_range``), indexed megablast (``use_index``) and the
database's soft and hard masks, over a database held resident on one
device (int64 subject coordinates throughout) or, where the card cannot
hold it, streamed through the card in blocks (engine.stream, which
reads GBLASTN_TPU_STREAM, GBLASTN_TPU_STREAM_THRESHOLD and the block
variables), or sharded over cards and processes with one shard
resident on each card (parallel.dist, which reads GBLASTN_TPU_SHARDS and
the process group's variables; a sharded batch never streams). A
streamed or sharded batch skips the gapped filter, which reads the
resident subject.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from gblastn_tpu_torch.hits import (
    HSPList,
    HitList,
    hitlist_update,
    sort_by_evalue,
    sort_hsplists_by_evalue,
)
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.query import QueryBlock, build_query_block
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.lut.builder import (
    build_disc_lookup_table,
    build_lookup_table,
    unmasked_locations,
)
from gblastn_tpu_torch.params.derived import SearchParams, derive_params
from gblastn_tpu_torch.params.options import SearchOptions
from gblastn_tpu_torch.stats.karlin import nucl_score_matrix
from gblastn_tpu_torch.traceback.stage import traceback_from_hsplist
from gblastn_tpu_torch.utils.profiling import slog
from gblastn_tpu_torch.device import resolve_device
from gblastn_tpu_torch.engine.gapped import (
    DeviceGappedData,
    build_device_gapped,
    run_gapped_prelim,
)
from gblastn_tpu_torch.engine.resident import resident_from_reference
from gblastn_tpu_torch.engine.seeding import (
    SeedingDeviceData,
    drive,
    run_seeding_steps,
)
from gblastn_tpu_torch.engine.stream import (
    StreamedDB,
    choose,
    run_seeding_streamed_steps,
)
from gblastn_tpu_torch.ops.replay import query_bytes
from gblastn_tpu_torch.ops.seeding import pack_query_nibbles, scan_span
from gblastn_tpu_torch.ops.ungapped import make_table64, pack_query
from gblastn_tpu_torch.parallel.dist import (
    ShardedDB,
    batch_cards,
    init_distributed,
    process_group,
    run_seeding_sharded_steps,
    shard_count,
    shard_db,
    shards_requested,
)

NEG_CLIP = -(1 << 24)


def device_matrix16(reward: int, penalty: int) -> np.ndarray:
    """BLASTNA x 2na score submatrix, sentinel rows clipped so int32
    accumulation in the device X-drop walk cannot overflow."""
    m = nucl_score_matrix(reward, penalty)[:, :4].astype(np.int64)
    return np.clip(m, NEG_CLIP, None).astype(np.int32)


@dataclass
class QueryResult:
    """Finished results for one query: HSP lists by subject, ranked."""

    query_index: int
    hsplists: list[HSPList] = field(default_factory=list)


@dataclass
class BlastResults:
    qblock: QueryBlock
    params: SearchParams
    queries: list[QueryResult] = field(default_factory=list)
    # per-context inclusive (from, to) masked ranges in concatenated-
    # buffer coordinates (dust/windowmasker/lcase), or None
    masks: list[list[tuple[int, int]]] | None = None


@dataclass
class PrelimResult:
    """Handoff between the prelim stage and traceback."""

    qblock: QueryBlock
    params: SearchParams
    hitlists: list[HitList]
    masks: list[list[tuple[int, int]]] | None = None


def _warn_once(db, key: str, msg: str) -> None:
    seen = getattr(db, "_warned", None)
    if seen is None:
        seen = set()
        db._warned = seen
    if key not in seen:
        seen.add(key)
        print(f"gblastn_tpu: {msg}", file=sys.stderr)


def _resolve_db_index(db, options):
    """Load + validate the -use_index database index, or None.

    The loaded index is cached on the db object; every reason to fall
    back to the scan path is warned once per database (the reference
    treats a missing index the same way, CIndexedDbException handling
    in mb_indexed_lookup.c)."""
    if not options.use_index:
        return None
    from gblastn_tpu_torch.lut.dbindex import (
        INDEX_SUFFIX,
        index_compatible,
        load_db_index,
    )

    cached = getattr(db, "_db_index_cache", None)
    if cached is None:
        name = options.index_name or getattr(db, "_source_path", None)
        if name is None:
            _warn_once(db, "idx", "-use_index: no -index_name and the "
                       "database has no on-disk path; scanning instead")
            db._db_index_cache = False
            return None
        try:
            cached = load_db_index(str(name))
        except FileNotFoundError:
            _warn_once(
                db, "idx",
                f"-use_index: index {name}{INDEX_SUFFIX} not found "
                "(build one with makembindex); scanning instead",
            )
            cached = False
        except Exception as e:  # malformed file
            _warn_once(db, "idx", f"-use_index: cannot load index: {e}; "
                       "scanning instead")
            cached = False
        db._db_index_cache = cached
    if cached is False:
        return None
    reason = index_compatible(cached, db, options.word_size)
    if reason is not None:
        _warn_once(db, "idx", f"-use_index: {reason}; scanning instead")
        return None
    return cached


def _db_mask_intervals(db, options) -> np.ndarray | None:
    """The database mask intervals (int64[n, 2], sorted, absolute) of
    -db_soft_mask / -db_hard_mask, or None; a hard mask also renders the
    masked bases as N on the host (``db.apply_hard_mask``). The two
    options exclude each other (ValueError); an algorithm the database
    lacks raises KeyError."""
    if (options.db_soft_mask is not None
            and options.db_hard_mask is not None):
        raise ValueError(
            "-db_soft_mask and -db_hard_mask are mutually exclusive"
        )
    algo = (options.db_soft_mask if options.db_soft_mask is not None
            else options.db_hard_mask)
    if algo is None:
        return None
    ivs = db.mask_intervals(int(algo))
    if options.db_hard_mask is not None:
        db.apply_hard_mask(int(algo))
    return ivs


def _index_on_device(db, index, dev):
    """The database index's CSR (int32 offsets rebuilt from its sorted
    words, int32 subject positions) on ``dev``, uploaded once and cached
    on the db object per device."""
    cache = getattr(db, "_torch_index", None)
    if cache is None or cache[0] is not index:
        cache = (index, {})
        db._torch_index = cache
    got = cache[1].get(dev)
    if got is None:
        with slog.time("setup.index_upload"):
            got = (torch.from_numpy(index.offsets()).to(dev),
                   torch.from_numpy(np.ascontiguousarray(
                       index.positions, np.int32)).to(dev))
        cache[1][dev] = got
    return got


@dataclass
class BatchSetup:
    """A query batch ready for the device seeding stage."""

    qblock: QueryBlock
    params: SearchParams
    masks: list[list[tuple[int, int]]] | None
    seed_dev: SeedingDeviceData
    seed_kw: dict           # run_seeding keywords (= ungapped_inputs')
    query: torch.Tensor     # uint8[Q] query bytes on the device (K2 reads)
    oracle_kw: dict         # the host finish's own inputs: word_cutoffs,
                            # subject_starts, approx_ctx (the keywords of
                            # engine.seeding._finish_init_hits; also
                            # seed_dev.finish_kw)
    stream: StreamedDB | None = None   # the streamed database, or None
    shards: ShardedDB | None = None    # the sharded database, or None;
                                       # with neither, seed_dev.resident
                                       # holds it


def setup_batch(
    records: list[FastaRecord],
    db: SequenceDB,
    options: SearchOptions,
    device: str | torch.device = "cuda",
) -> BatchSetup:
    """Host setup of one batch (query block, masks, lookup table, derived
    parameters, gate data) and its upload beside the resident database,
    or, where the database is sharded (parallel.dist: GBLASTN_TPU_SHARDS,
    a process group, or a bare ``cuda`` on a machine with several cards)
    or streams (engine.stream.choose), without it."""
    init_distributed()
    dev = resolve_device(device)
    options.validate()
    cards = batch_cards(device, dev)
    n_shards = shard_count(shards_requested(), world=process_group()[0],
                           cards=len(cards))
    with slog.time("setup.query_block"):
        qblock = build_query_block(records, options.strand)
    ctx_offsets = qblock.context_offsets()
    ctx_lengths = [c.length for c in qblock.contexts]

    loc_ranges = None       # per-context clamped -query_loc (a, b)
    if options.query_loc is not None:
        # -query_loc: statistics use the restricted range lengths
        a0, b0 = options.query_loc
        loc_ranges = []
        for c in qblock.contexts:
            a = min(max(a0, 0), c.length)
            b = min(max(b0, a), c.length)
            loc_ranges.append((a, b))
        params = derive_params(
            options, [b - a for a, b in loc_ranges],
            db.total_length, db.num_seqs,
        )
    else:
        params = derive_params(
            options, ctx_lengths, db.total_length, db.num_seqs
        )

    masks = None
    if options.dust:
        from gblastn_tpu_torch.masking.dust import query_dust_masks

        with slog.time("setup.dust"):
            masks = query_dust_masks(
                qblock, options.dust_level, options.dust_window,
                options.dust_linker, query_loc=options.query_loc,
            )
    if options.window_masker_db:
        from gblastn_tpu_torch.masking.winmask import (
            WindowMaskerStats,
            query_window_masks,
        )

        with slog.time("setup.window_masker"):
            stats = WindowMaskerStats.load(options.window_masker_db)
            wm_masks = query_window_masks(qblock, stats)
        if masks is None:
            masks = wm_masks
        else:
            masks = [sorted(a + b) for a, b in zip(masks, wm_masks)]
    if options.lcase_masking:
        from gblastn_tpu_torch.masking.lcase import query_lcase_masks

        lc_masks = query_lcase_masks(qblock, records)
        if masks is None:
            masks = lc_masks
        else:
            masks = [sorted(a + b) for a, b in zip(masks, lc_masks)]
    if options.filtering_db:
        from gblastn_tpu_torch.masking.repeats import (
            load_repeat_db,
            query_repeat_masks,
        )

        # a nested blastn search against the repeat database, on this
        # batch's device (its resident copy is cached on its own db)
        with slog.time("setup.repeat_filter"):
            rep_masks = query_repeat_masks(
                qblock, records, load_repeat_db(options.filtering_db), dev
            )
        if masks is None:
            masks = rep_masks
        else:
            masks = [sorted(a + b) for a, b in zip(masks, rep_masks)]
    if loc_ranges is not None:
        # sentinel-fence the range: bases outside [start, stop) become
        # sentinels, so seeding skips them and every extension stops at
        # the range edge exactly like a context boundary
        for c, (a, b) in zip(qblock.contexts, loc_ranges):
            L = c.length
            lo, hi = (a, b) if c.frame >= 0 else (L - b, L - a)
            qblock.buffer[c.offset: c.offset + lo] = 15
            qblock.buffer[c.offset + hi: c.offset + L] = 15

    locations = unmasked_locations(qblock.buffer, ctx_offsets, masks)

    if masks is not None and not options.mask_at_hash:
        # -soft_masking false: render masked bases as N for the whole
        # search (BlastSetUp_MaskQuery, blast_filter.c:991)
        qblock.buffer_nomask = qblock.buffer.copy()
        for ctx_masks in masks:
            for a, b in ctx_masks:
                qblock.buffer[a: b + 1] = 14

    # indexed megablast (-use_index): resolve the database index before
    # the lookup table, whose width is forced to the index's (the seed
    # set then equals a scan's at that width; lut/dbindex.py); an
    # unusable index warns once and the search scans
    db_index = _resolve_db_index(db, options)
    if db_index is not None and options.template_length:
        _warn_once(
            db, "idx-disc",
            "-use_index does not apply to discontiguous megablast; "
            "scanning instead",
        )
        db_index = None
    # -db_soft_mask / -db_hard_mask: masked subject words are not seeded
    db_mask_ivs = _db_mask_intervals(db, options)

    lut2 = None   # the second template's table (coding_and_optimal)
    with slog.time("setup.lookup_table"):
        if options.template_length:
            pair = options.template_type == "coding_and_optimal"
            lut = build_disc_lookup_table(
                qblock.buffer, locations, options.word_size,
                options.template_length,
                "coding" if pair else options.template_type,
            )
            if pair:
                lut2 = build_disc_lookup_table(
                    qblock.buffer, locations, options.word_size,
                    options.template_length, "optimal",
                )
        else:
            lut = build_lookup_table(
                qblock.buffer, locations, options.word_size,
                db_index.lut_word if db_index is not None
                else options.lut_word_size,
            )

    n_ctx = len(qblock.contexts)
    word_cutoffs = np.array(
        [params.contexts[c].word_cutoff_score for c in range(n_ctx)],
        dtype=np.int32,
    )
    x_dropoffs = np.array(
        [params.contexts[c].x_dropoff_ungapped for c in range(n_ctx)],
        dtype=np.int32,
    )

    # query buffer rounded up to whole nibble words with sentinels
    qbuf = np.full(-(-len(qblock.buffer) // 8) * 8, 15, np.uint8)
    qbuf[: len(qblock.buffer)] = qblock.buffer

    # approximate-ungapped gate data (s_NuclUngappedExtend semantics):
    # the device finish (G) demotes exact-passing seeds whose
    # byte-quantized score misses the reduced cutoff, as the reference
    # does for word >= 11; approx_ctx is the same data for the host
    # finish (engine.seeding._finish_init_hits, in oracle_kw), which the
    # off-diagonal replay and the streamed path run
    from gblastn_tpu_torch.params.derived import nucl_score_table_packed

    reduced = np.array(
        [params.contexts[c].reduced_nucl_cutoff for c in range(n_ctx)],
        np.int64,
    )
    table256 = nucl_score_table_packed(options.reward, options.penalty)
    approx_ctx = {
        "query": qbuf,
        "concat_end": len(qblock.buffer) - 1,
        "packed": db.packed,
        "subject_ends": np.asarray(db.starts) + np.asarray(db.lengths),
        "x_dropoffs": x_dropoffs,
        "reduced": reduced,
        "table": table256,
    }

    m16 = device_matrix16(options.reward, options.penalty)
    span = scan_span(lut.lut_word_size, lut.disc_offsets)
    stream = shards = None
    if n_shards > 1:
        shards = shard_db(db, dev, n_shards, cards=cards,
                          span=span, scan_step=lut.scan_step,
                          mask_intervals=db_mask_ivs, db_index=db_index,
                          matrix16=m16, query=qbuf)
    else:
        stream = choose(db, dev, span=span, scan_step=lut.scan_step,
                        mask_intervals=db_mask_ivs, db_index=db_index,
                        matrix16=m16, query=qbuf)
    resident = None
    if stream is None and shards is None:
        with slog.time("setup.subject_upload"):
            resident = resident_from_reference(db, dev)
    oracle_kw = dict(word_cutoffs=word_cutoffs, subject_starts=db.starts,
                     approx_ctx=approx_ctx)
    with slog.time("setup.batch_upload"):
        q_dev = torch.from_numpy(qbuf).to(dev)

        def csr(t):
            positions = (t.positions if len(t.positions)
                         else np.zeros(1, np.int32))
            return (torch.from_numpy(t.counts_offsets).to(dev),
                    torch.from_numpy(positions).to(dev))

        offsets, positions = csr(lut)
        offsets2, positions2 = csr(lut2) if lut2 is not None else (None,
                                                                   None)
        q_allowed = None
        if db_index is not None:
            # the scan walks the query: the table's offsets mark the
            # allowed words, and the lut_* fields hold the index's CSR
            allowed = np.zeros(len(qbuf), bool)
            allowed[lut.positions] = True
            q_allowed = torch.from_numpy(allowed).to(dev)
            if resident is not None:   # a block or shard takes its slice
                offsets, positions = _index_on_device(db, db_index, dev)
        mask_starts = mask_ends = None
        if db_mask_ivs is not None and len(db_mask_ivs):
            ivs = torch.from_numpy(np.ascontiguousarray(
                db_mask_ivs, np.int64).T.copy()).to(dev)
            mask_starts, mask_ends = ivs[0], ivs[1]
        seed_dev = SeedingDeviceData(
            resident=resident,
            query_packed=pack_query(q_dev),
            query_nib=pack_query_nibbles(q_dev),
            lut_offsets=offsets,
            lut_positions=positions,
            table64=torch.from_numpy(make_table64(m16)).to(dev),
            qbytes=query_bytes(q_dev),
            table256=torch.from_numpy(table256.astype(np.int32)).to(dev),
            ctx_tables=torch.from_numpy(np.stack(
                [word_cutoffs, reduced, x_dropoffs]).astype(np.int32)
            ).to(dev),
            window=options.window_size,
            lut2_offsets=offsets2,
            lut2_positions=positions2,
            query=q_dev,
            q_allowed=q_allowed,
            mask_starts=mask_starts,
            mask_ends=mask_ends,
            finish_kw=oracle_kw,
        )
    seed_kw = dict(
        word_size=lut.word_size,
        lut_word=lut.lut_word_size,
        scan_step=lut.scan_step,
        context_offsets=ctx_offsets,
        x_dropoffs=x_dropoffs,
        disc_offsets=lut.disc_offsets,
        disc_offsets2=lut2.disc_offsets if lut2 is not None else None,
        scan_range=options.off_diagonal_range if options.window_size else 0,
    )
    return BatchSetup(qblock, params, masks, seed_dev, seed_kw, q_dev,
                      oracle_kw, stream, shards)


def _build_gapped_filter(batch: BatchSetup) -> DeviceGappedData | None:
    """Device banded-DP gapped pre-filter context, or None when off.

    GBLASTN_TPU_GAPPED_FILTER: auto (default: on when the search runs on
    a CUDA device), 1 (force; on the CPU the plain version runs), 0
    (off). Queries longer than the kernel's row budget disable the
    filter (every candidate would flag FLAG_ROWS and fall back to host
    anyway)."""
    mode = os.environ.get("GBLASTN_TPU_GAPPED_FILTER", "auto")
    if mode in ("0", "off"):
        return None
    if mode == "auto" and batch.query.device.type != "cuda":
        return None
    if not batch.params.options.gapped:
        return None
    maxlen = max((c.length for c in batch.qblock.contexts), default=0)
    rows = 256
    while rows < maxlen + 192:
        rows *= 2
    if rows > 4096:
        return None
    return build_device_gapped(
        batch.params, batch.query, batch.seed_dev.resident.subject2, rows
    )


def prelim_search(
    records: list[FastaRecord],
    db: SequenceDB,
    options: SearchOptions,
    device: str | torch.device = "cuda",
    interrupt_fn=None,
) -> PrelimResult:
    """Device seeding + host prelim gapped stage + hitlist collection.

    ``interrupt_fn`` (optional, () -> bool) is polled at stage
    boundaries; returning True raises SearchInterrupted."""
    return drive(prelim_search_steps(records, db, options, device,
                                     interrupt_fn))


def prelim_search_steps(
    records: list[FastaRecord],
    db: SequenceDB,
    options: SearchOptions,
    device: str | torch.device = "cuda",
    interrupt_fn=None,
):
    """Generator form of prelim_search: yields exactly once, after the
    batch's seeding is launched on the card and before its one wait
    (``run_seeding_steps``), so a pipelining caller can run host work of
    the previous batch while the card computes (engine.pipeline). No
    span is open across the yield: ``device.seeding`` times the launch
    and the fetch as two parts. The PrelimResult arrives as
    StopIteration.value. Queries are searched whole, however long (the
    JAX package's prelim_search_steps does not split either)."""
    from gblastn_tpu_torch.utils.interrupt import check

    check(interrupt_fn)
    batch = setup_batch(records, db, options, device)
    qblock, params, masks = batch.qblock, batch.params, batch.masks
    with slog.time("device.seeding"):
        if batch.shards is not None:
            sgen = run_seeding_sharded_steps(batch.shards, batch.seed_dev,
                                             **batch.seed_kw)
        elif batch.stream is not None:
            sgen = run_seeding_streamed_steps(batch.stream, batch.seed_dev,
                                              **batch.seed_kw)
        else:
            sgen = run_seeding_steps(batch.seed_dev, **batch.seed_kw)
        next(sgen)
    yield
    with slog.time("device.seeding"):
        init = drive(sgen)
    # the JAX package's engage rule (gblastn_tpu/engine/search.py:930):
    # the filter runs from GBLASTN_TPU_GAPPED_FILTER_MIN candidates up,
    # or always when GBLASTN_TPU_GAPPED_FILTER=1; it reads the resident
    # subject, so a streamed or sharded batch does not run it (an exact
    # rejection filter: no result changes)
    filter_min = int(os.environ.get("GBLASTN_TPU_GAPPED_FILTER_MIN",
                                    "2000"))
    device_gapped = None
    if batch.seed_dev.resident is not None and (
            len(init) >= filter_min
            or os.environ.get("GBLASTN_TPU_GAPPED_FILTER") == "1"):
        device_gapped = _build_gapped_filter(batch)
    slog.diagnostics.good_init_extends += len(init)
    check(interrupt_fn)

    if options.gapped:
        with slog.time("host.prelim_gapped"):
            prelim_lists = run_gapped_prelim(
                init, qblock, db.get_sequence_2na_cached, db.starts,
                params, device_gapped=device_gapped,
                subject_lengths=db.lengths,
            )
    else:
        from gblastn_tpu_torch.engine.ungapped import run_ungapped_prelim

        with slog.time("host.prelim_ungapped"):
            prelim_lists = run_ungapped_prelim(
                init, qblock, db.starts, db.lengths, params
            )
    slog.diagnostics.good_gapped += sum(len(l.hsps) for l in prelim_lists)

    # split per-subject lists by query and collect per-query hitlists;
    # the best-hit / culling writers replace the default collector when
    # configured (hspfilter_besthit.c / hspfilter_culling.c)
    hitlist_size = options.max_target_seqs or options.hitlist_size
    hitlists = [
        HitList(hitlist_size=hitlist_size) for _ in range(qblock.num_queries)
    ]
    besthit = culling = None
    if options.best_hit_overhang > 0 or options.best_hit_score_edge > 0:
        from gblastn_tpu_torch.hspfilters import BestHitWriter

        besthit = BestHitWriter(
            qblock.num_queries,
            options.best_hit_overhang or 0.1,
            options.best_hit_score_edge or 0.1,
        )
    elif options.culling_limit > 0:
        from gblastn_tpu_torch.hspfilters import CullingWriter

        culling = CullingWriter(len(qblock.contexts), options.culling_limit)

    with slog.time("host.collect"):
        if besthit is not None or culling is not None:
            from gblastn_tpu_torch.hits import sort_by_score

            writer = besthit if besthit is not None else culling
            for lst in prelim_lists:
                by_query: dict[int, HSPList] = {}
                for h in lst.hsps:
                    qi = qblock.contexts[h.context].query_index
                    by_query.setdefault(
                        qi, HSPList(oid=lst.oid)
                    ).hsps.append(h)
                for sub in by_query.values():
                    writer.add_hsplist(sub, qblock)
            for qi in range(qblock.num_queries):
                if besthit is not None:
                    kept = besthit.export(qi)
                else:
                    kept = culling.export_query(qblock, qi)
                for sub in kept:
                    sort_by_score(sub.hsps)
                    hitlist_update(hitlists[qi], sub)
        else:
            for lst in prelim_lists:
                by_query = {}
                for h in lst.hsps:
                    qi = qblock.contexts[h.context].query_index
                    by_query.setdefault(
                        qi, HSPList(oid=lst.oid)
                    ).hsps.append(h)
                for qi, sub in by_query.items():
                    hitlist_update(hitlists[qi], sub)

    return PrelimResult(qblock=qblock, params=params, hitlists=hitlists,
                        masks=masks)


def finish_search(
    prelim: PrelimResult,
    db: SequenceDB,
    options: SearchOptions,
    interrupt_fn=None,
) -> BlastResults:
    """Traceback + final ranking over a prelim result (host only)."""
    from gblastn_tpu_torch.utils.interrupt import check

    qblock = prelim.qblock
    params = prelim.params
    hitlists = prelim.hitlists
    hitlist_size = options.max_target_seqs or options.hitlist_size

    matrix = nucl_score_matrix(options.reward, options.penalty)
    results = BlastResults(qblock=qblock, params=params,
                           masks=prelim.masks)
    subj_cache: dict[int, np.ndarray] = {}

    def _finish_one(lst):
        if options.gapped:
            traceback_from_hsplist(
                lst, qblock, subj_cache[lst.oid], matrix, params
            )
        else:
            from gblastn_tpu_torch.engine.ungapped import (
                finish_ungapped_hsplist,
            )

            finish_ungapped_hsplist(
                lst, qblock, subj_cache[lst.oid], matrix,
                params, int(db.lengths[lst.oid]),
            )

    nthreads = max(int(getattr(options, "num_threads", 1) or 1), 1)
    with slog.time("host.traceback"):
        if nthreads > 1:
            # -num_threads: per-HSPList traceback fan-out; the native
            # aligners release the GIL inside each ctypes call, and each
            # task mutates only its own HSPList. Subjects prefetch
            # serially first (the cache dict is not thread-safe).
            from concurrent.futures import ThreadPoolExecutor

            all_lists = []
            for hl in hitlists:
                for lst in hl.hsplists:
                    if lst.oid not in subj_cache:
                        subj_cache[lst.oid] = (
                            db.get_sequence_blastna_cached(lst.oid)
                        )
                    all_lists.append(lst)
            check(interrupt_fn)
            with ThreadPoolExecutor(max_workers=nthreads) as pool:
                list(pool.map(_finish_one, all_lists))
        for qi, hl in enumerate(hitlists):
            check(interrupt_fn)
            qres = QueryResult(query_index=qi)
            for lst in hl.hsplists:
                if nthreads <= 1:
                    if lst.oid not in subj_cache:
                        subj_cache[lst.oid] = (
                            db.get_sequence_blastna_cached(lst.oid)
                        )
                    _finish_one(lst)
                if lst.hsps:
                    qres.hsplists.append(lst)
            # final ranking (Blast_HSPResultsSortByEvalue)
            for lst in qres.hsplists:
                sort_by_evalue(lst.hsps)
                lst.best_evalue = min(h.evalue for h in lst.hsps)
            sort_hsplists_by_evalue(qres.hsplists)
            del qres.hsplists[hitlist_size:]
            slog.diagnostics.final_hsps += sum(
                len(l.hsps) for l in qres.hsplists
            )
            results.queries.append(qres)
    return results


def search(
    records: list[FastaRecord],
    db: SequenceDB,
    options: SearchOptions,
    device: str | torch.device = "cuda",
    interrupt_fn=None,
) -> BlastResults:
    """Run a complete nucleotide search (megablast, blastn, blastn-short,
    vecscreen, dc-megablast) end to end on ``device`` ("cuda" or "cpu";
    "cuda" without a card raises).

    Queries longer than the task chunk size are transparently split
    into overlapping chunks and the results stitched back
    (engine.split, the role of split_query_cxx.cpp)."""
    from gblastn_tpu_torch.engine.split import (
        chunk_size_for_task,
        merge_chunk_prelim,
        overlap_size,
        split_records,
    )

    chunk = chunk_size_for_task(options.task.value)
    recs2, info, any_split = split_records(
        records, chunk, overlap_size()
    )
    if not any_split:
        return finish_search(
            prelim_search(records, db, options, device, interrupt_fn),
            db, options, interrupt_fn,
        )

    # merge at the PRELIM stage (BlastHSPStreamMerge semantics): chunk
    # HSPs remap to original coordinates, boundary HSPs concatenate,
    # and the traceback runs over the ORIGINAL query block so merged
    # boxes re-extend exactly as unsplit ones (blast_hits.c:2545)
    sub = prelim_search(recs2, db, options, device, interrupt_fn)
    qblock_orig = build_query_block(records, options.strand)
    n_ctx_per_query = 2 if options.strand == "both" else 1
    hitlist_size = options.max_target_seqs or options.hitlist_size
    params_orig = derive_params(
        options, [c.length for c in qblock_orig.contexts],
        db.total_length, db.num_seqs,
    )
    merged = merge_chunk_prelim(
        sub, info, len(records), n_ctx_per_query,
        qblock_orig, params_orig, options.gapped, overlap_size(),
        hitlist_size,
    )
    return finish_search(merged, db, options, interrupt_fn)
