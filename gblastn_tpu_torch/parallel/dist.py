"""Database sharding over cards and processes: seeding with one shard of
the database resident on each card.

The port's counterpart of ``gblastn_tpu/parallel/dist.py``. The
reference runs N prelim-search threads over one subject iterator and
merges their HSPs through a locked stream (NCBI prelim_stage.cpp:139;
multi-GPU checkout gpu_blast_multi_gpu_utils.cpp:105-154); as in the JAX
package, the port shards the database instead:

* the database is cut into ``n`` contiguous shards, each a block of the
  stream's geometry (``shard_plan``: an engine.stream._BlockPlan whose
  block is ceil(padded_length / n) bases rounded up to lcm(1024,
  scan_step), with the stream's halo, GBLASTN_TPU_BLOCK_HALO), so each
  shard owns a disjoint range of global stride positions, together the
  resident scan's: the seed set is the resident path's, and no seed is
  found twice; a shard with no work is skipped;
* shard k belongs to process k % world and, inside it, to card
  (k // world) % cards (``place_shards``); a card may hold several
  shards, and a cuda batch places none on the CPU;
* each shard's resident form (packed bytes, codes, validity and words,
  engine.resident's 2.75 bytes a base of its buffer) is held against its
  card's free memory (engine.resident.check_fits: a shard that does not
  fit raises MemoryError, since a sharded batch never streams), built
  once and cached on the db per plan and card, so a later batch uploads
  nothing;
* per shard with seeds, on its card: the scan, the mini-extension, K1,
  RR where it probes and G (engine.stream.launch_block), the seeds kept
  in global int64 coordinates;
* in one process every shard's columns move to the batch's card, are
  joined in (template, shard) order and the walks at a shard's buffer
  edge are re-extended exactly on the host (engine.stream.escalate);
  across processes each rank escalates its own shards' walks, fetches
  its columns once and all_gathers them over gloo (host arrays only, so
  ranks may share a card), and every rank joins all of them in the same
  order and uploads them to its card;
* then the resident path's finish once a batch over the whole database's
  seeds: the sort and R on the batch's card, or with a scan range the
  host replay (engine.stream.finish_joined).

The device gapped filter K2 reads the resident subject, so a sharded
batch does not run it, as in the JAX package; it is an exact rejection
filter, so leaving it out changes no result. Every rank of a process
group runs the whole search and writes its own output, as every JAX
process does.

Spans: ``setup.shard_upload`` (building the shards' forms),
``device.seeding.sharded`` (the shards' launches), ``host.shard_escalate``
and ``host.shard_gather`` (the all_gather across processes); values:
``seeding.shards`` (the plan's shard count) and, per process,
``seeding.shard_escalated`` and ``seeding.shard_gate_edges``.

Left out, as TPU workarounds that were exact: ``shard_map`` and the mesh
(``make_mesh``, with its fallback to a virtual CPU mesh), ``_put``, the
hit, seed and out caps with their overflow retry, ``use_pallas`` and
``prepare_subject``, ``make_sharded_seeding``'s jit cache, the pow2
buckets of the bounds, mask and index slices with their int32 clip and
the refusal of shard windows of 2^31 bases (coordinates are int64), and
``_host_extend_arrays`` over the unpacked codes (the host re-extends off
the packed database, engine.stream.ungapped_extend_host).
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import sys
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from gblastn_tpu_torch.engine.resident import check_fits
from gblastn_tpu_torch.engine.seeding import (
    InitHits,
    SeedingDeviceData,
    drive,
    probes_double_words,
)
from gblastn_tpu_torch.engine.stream import (
    StreamedDB,
    _BlockPlan,
    _block_index_slices,
    _env_int,
    block_resident,
    escalate,
    finish_blocks,
    finish_joined,
    join_blocks,
    launch_block,
)
from gblastn_tpu_torch.utils.profiling import slog

# seconds a process waits for the others at the process group's start and
# at each gather before it raises
INIT_TIMEOUT_S = 300.0
# the seed columns a process gathers, and the wide (int64) ones among them
_COLUMNS = ("q", "ctx", "oid", "ss", "uq", "us", "ulen", "usc")
_WIDE = ("ss", "us")


# ---------------------------------------------------------- process group
def init_distributed(timeout: float = INIT_TIMEOUT_S) -> bool:
    """Join the process group the environment names; whether there is
    one. The JAX package's contract: GBLASTN_TPU_COORDINATOR=host:port
    with GBLASTN_TPU_NUM_PROCESSES and GBLASTN_TPU_PROCESS_ID (gloo over
    ``tcp://host:port``), or ``auto`` (``env://``, as torchrun sets it).
    A no-op where the variable is unset or the group is live. A
    coordinator that cannot be reached raises after ``timeout`` seconds;
    there is no fallback to a run alone. On joining, the rank's card
    (LOCAL_RANK, else the rank, modulo the visible cards) becomes the
    current one, so a bare ``cuda`` device resolves to it; gloo carries
    host arrays only, so ranks may share a card."""
    coord = os.environ.get("GBLASTN_TPU_COORDINATOR")
    if not coord:
        return False
    import torch.distributed as td

    if td.is_initialized():
        return True
    wait = datetime.timedelta(seconds=timeout)
    if coord == "auto":
        td.init_process_group("gloo", init_method="env://", timeout=wait)
    else:
        td.init_process_group(
            "gloo", init_method=f"tcp://{coord}", timeout=wait,
            world_size=int(os.environ["GBLASTN_TPU_NUM_PROCESSES"]),
            rank=int(os.environ["GBLASTN_TPU_PROCESS_ID"]))
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", td.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return True


def process_group() -> tuple[int, int]:
    """(world size, rank) of the live process group, else (1, 0)."""
    import torch.distributed as td

    if td.is_available() and td.is_initialized():
        return td.get_world_size(), td.get_rank()
    return 1, 0


# ------------------------------------------------------- the pure functions
def shards_requested() -> int:
    """GBLASTN_TPU_SHARDS as the reference reads it: a value that is not
    a number, the empty one included, is ignored with a note on stderr
    (0: unset)."""
    try:
        return int(os.environ.get("GBLASTN_TPU_SHARDS", "0"))
    except ValueError:
        print("gblastn_tpu: ignoring non-numeric GBLASTN_TPU_SHARDS",
              file=sys.stderr)
        return 0


def shard_count(requested: int, *, world: int, cards: int) -> int:
    """The batch's shard count: ``requested`` (GBLASTN_TPU_SHARDS) where
    it is set (not 0); else the world size under a process group of more
    than one process; else ``cards``, the cards a bare-cuda batch sees
    (1 for any other batch), as the JAX package shards over every chip of
    a multi-chip TPU."""
    if requested:
        return max(requested, 1)
    if world > 1:
        return world
    return max(cards, 1)


def place_shards(n: int, *, world: int, cards: int) -> list[tuple[int, int]]:
    """(process, card) of each of ``n`` shards: shard k belongs to process
    k % world and, inside it, to card (k // world) % cards (a card holds
    several shards where there are more shards than cards)."""
    return [(k % world, (k // world) % cards) for k in range(n)]


def shard_plan(db, n: int, *, span: int, scan_step: int, halo: int,
               mask_intervals=None) -> _BlockPlan:
    """The stream's geometry with one block a shard: ``n`` blocks of
    ceil(padded_length / n) bases rounded up to lcm(1024, scan_step)
    (trailing ones may have no work), each with ``halo`` bases of context
    on each side."""
    align = math.lcm(1024, scan_step)
    per = -(-db.padded_length // n)
    return _BlockPlan(db, block_bases=-(-per // align) * align, halo=halo,
                      span=span, scan_step=scan_step,
                      mask_intervals=mask_intervals, n_blocks=n)


def batch_cards(device, dev: torch.device) -> list[torch.device]:
    """The devices a batch's shards may go to: for a bare ``cuda``
    (``device`` as the caller named it) every visible card from the
    current one (``dev``) on, for a numbered card that card, for the CPU
    the CPU."""
    if dev.type != "cuda" or torch.device(device).index is not None:
        return [dev]
    n = torch.cuda.device_count()
    return [torch.device("cuda", (dev.index + i) % n) for i in range(n)]


# ------------------------------------------------------------ the shard forms
@dataclass
class ShardedDB:
    """A batch's sharded database: the plan and host data (a
    StreamedDB whose blocks are the shards, on the batch's device) and
    this process's shards with work, in shard order, each as (its
    ResidentDB on its card, its index slice's words and local positions
    or None)."""

    blocks: StreamedDB
    forms: dict
    world: int
    rank: int


def _shard_form(sdb: StreamedDB, k: int, device: torch.device):
    """Shard k's forms on ``device``, from the db's cache (per plan and
    card) or built: held against the card's free memory first."""
    db, plan = sdb.db, sdb.plan
    cache = getattr(db, "_torch_shards", None)
    if cache is None:
        cache = {}
        db._torch_shards = cache
    geom = (plan.B, plan.halo, plan.n_blocks, k, device)
    res_key = ("resident", geom)
    idx_key = ("index", geom, sdb.index_key)
    res = cache.get(res_key)
    index = None if sdb.index_slices is None else cache.get(idx_key)
    need = 0 if res is not None else plan.block_bytes() + 16 * len(
        plan.bounds(k)[0])
    if sdb.index_slices is not None and index is None:
        need += sum(a.nbytes for a in sdb.index_slices[k])
    if not need:
        return res, index
    check_fits(need, device, what=f"shard {k} of {plan.n_blocks}",
               instead="a sharded batch does not stream: raise "
                       "GBLASTN_TPU_SHARDS or add cards")
    with slog.time("setup.shard_upload"):
        if res is None:
            res = block_resident(plan, k, torch.from_numpy(
                plan.packed(db, k)).to(device))
            cache[res_key] = res
        if sdb.index_slices is not None and index is None:
            index = tuple(torch.from_numpy(a).to(device)
                          for a in sdb.index_slices[k])
            cache[idx_key] = index
    return res, index


def shard_db(db, dev: torch.device, n: int, *, cards: list, span: int,
             scan_step: int, mask_intervals, db_index,
             matrix16: np.ndarray, query: np.ndarray) -> ShardedDB:
    """The batch's ShardedDB over ``n`` shards: the plan, this process's
    shards with work placed on ``cards`` (``place_shards``) and their
    forms built or taken from the cache. ``dev`` is the batch's device,
    ``query`` its query buffer and ``matrix16`` its score matrix (the
    host escalation reads them)."""
    world, rank = process_group()
    plan = shard_plan(db, n, span=span, scan_step=scan_step,
                      halo=_env_int("GBLASTN_TPU_BLOCK_HALO", 4096),
                      mask_intervals=mask_intervals)
    slices = (None if db_index is None
              else _block_index_slices(db, db_index, plan))
    sdb = StreamedDB(
        db=db, plan=plan, device=dev, cache_budget=0, index_slices=slices,
        index_key=(None if db_index is None
                   else (db_index.lut_word, db_index.word_size,
                         id(db_index))),
        matrix16=matrix16, query=query)
    forms = {}
    for k, (r, c) in enumerate(place_shards(n, world=world,
                                            cards=len(cards))):
        if (r == rank and plan.has_work(k)
                and (slices is None or len(slices[k][1]))):
            forms[k] = _shard_form(sdb, k, cards[c])
    return ShardedDB(blocks=sdb, forms=forms, world=world, rank=rank)


def _data_on(dev: SeedingDeviceData,
             device: torch.device) -> SeedingDeviceData:
    """The batch's device data with every tensor on ``device`` (the same
    object where it is there already)."""
    moved = {f.name: getattr(dev, f.name).to(device) for f in fields(dev)
             if isinstance(getattr(dev, f.name), torch.Tensor)}
    return replace(dev, **moved)


# --------------------------------------------------------------- the seeding
def run_seeding_sharded(shd: ShardedDB, dev: SeedingDeviceData,
                        **scan_kw) -> InitHits:
    """Sharded seeding over the whole database; the same InitHits as
    ``engine.seeding.run_seeding`` over the resident database (held equal
    in the tests). ``run_seeding_sharded_steps`` driven to its end."""
    return drive(run_seeding_sharded_steps(shd, dev, **scan_kw))


def run_seeding_sharded_steps(shd: ShardedDB, dev: SeedingDeviceData,
                              **scan_kw):
    """Generator form of ``run_seeding_sharded``: yields exactly once,
    after the first shard's launch, so that a pipelining caller
    (engine.pipeline) runs host work meanwhile. ``dev`` is the batch's
    device data without a resident database; ``scan_kw`` are
    ``scan_parts``' keywords with the finish's ``scan_range``. No span is
    open across the yield."""
    sdb = shd.blocks
    on_card = {}
    got, with_seeds = [], []
    n_raw = 0

    def launch(k):
        nonlocal n_raw
        res, index = shd.forms[k]
        kdev = on_card.get(res.device)
        if kdev is None:
            kdev = on_card[res.device] = _data_on(dev, res.device)
        # a shard's launches run with its card current
        with (torch.cuda.device(res.device) if res.device.type == "cuda"
              else contextlib.nullcontext()):
            item, raw = launch_block(sdb.plan, k, res, index, kdev, scan_kw)
        n_raw += raw
        if item is not None:
            got.append(item)
            with_seeds.append(k)

    ks = list(shd.forms)
    with slog.time("device.seeding.sharded"):
        if ks:
            launch(ks[0])
    yield                                   # the first shard launched
    with slog.time("device.seeding.sharded"):
        for k in ks[1:]:
            launch(k)
    slog.add_value("seeding.shards", sdb.plan.n_blocks)
    if shd.world == 1:
        slog.diagnostics.lookup_hits += n_raw
        got = [(counts, {name: c.to(sdb.device) for name, c in cols.items()},
                [h.to(sdb.device) for h in head])
               for counts, cols, head in got]
        return finish_blocks(sdb, dev, got, scan_kw, "shard")
    col, head = _gather(shd, dev, got, with_seeds, n_raw, scan_kw)
    slog.diagnostics.init_extends += int(col["q"].numel())
    return finish_joined(sdb, dev, col, head, scan_kw)


def _gather(shd: ShardedDB, dev: SeedingDeviceData, got: list,
            with_seeds: list, n_raw: int, scan_kw: dict):
    """Every process's seed columns on this process's batch device, in
    (template, shard) order, with the head of all of them (gated seeds
    summed, range flags at their most). This process first escalates its
    own shards' edge walks and fetches its columns once; then two
    all_gathers over gloo (the sizes, then the int64 payloads: raw seed
    count, the (template, shard, seeds) pieces, head and columns)."""
    import torch.distributed as td

    sdb = shd.blocks
    names = _COLUMNS + (("runs",) if probes_double_words(dev, scan_kw)
                        else ())
    pieces = []
    local = torch.zeros(3, dtype=torch.int64)
    if got:
        with slog.time("device.seeding.finish"):
            col, head = join_blocks(got)
        escalate(sdb, dev, col, head, scan_kw, "shard")
        pieces = [(t, k, counts[t]) for t in range(len(got[0][0]))
                  for k, (counts, _c, _h) in zip(with_seeds, got)]
        with slog.time("device.seeding.fetch"):
            local = torch.cat([
                torch.stack(head).long(),
                torch.stack([col[c].long() for c in names]).reshape(-1),
            ]).cpu()
    payload = torch.cat([torch.tensor([n_raw, len(pieces)], dtype=torch.int64),
                         torch.tensor(pieces, dtype=torch.int64).reshape(-1),
                         local])
    with slog.time("host.shard_gather"):
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(shd.world)]
        td.all_gather(sizes, torch.tensor([payload.numel()]))
        most = max(int(s) for s in sizes)
        sent = torch.zeros(most, dtype=torch.int64)
        sent[: payload.numel()] = payload
        outs = [torch.empty(most, dtype=torch.int64)
                for _ in range(shd.world)]
        td.all_gather(outs, sent)
    heads, parts, raw = [], [], 0
    for out in outs:
        a = out.numpy()
        raw += int(a[0])
        desc = a[2: 2 + 3 * int(a[1])].reshape(-1, 3)
        h0 = 2 + desc.size
        heads.append(a[h0: h0 + 3])
        n = int(desc[:, 2].sum())
        data = a[h0 + 3: h0 + 3 + len(names) * n].reshape(len(names), n)
        ends = np.cumsum(desc[:, 2])
        parts += [(int(t), int(k), data[:, e - m: e])
                  for (t, k, m), e in zip(desc, ends)]
    slog.diagnostics.lookup_hits += raw
    parts.sort(key=lambda p: p[:2])
    joined = (np.concatenate([p[2] for p in parts], 1) if parts
              else np.zeros((len(names), 0), np.int64))
    heads = np.stack(heads)
    with slog.time("device.seeding.finish"):
        t = torch.from_numpy(joined).to(sdb.device)
        col = {name: t[i].to(torch.int64 if name in _WIDE else torch.int32)
               for i, name in enumerate(names)}
        head = [torch.tensor(int(v), dtype=torch.int32, device=sdb.device)
                for v in (heads[:, 0].sum(), heads[:, 1].max(),
                          heads[:, 2].max())]
    return col, head
