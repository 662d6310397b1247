"""Subject block streaming in the port on the CPU (engine.stream): the
block plan's geometry, the host re-extension, the packed right runs,
``unpack_range`` and the index slices against the JAX package's; the
streamed seeding against the resident path, InitHits field by field, on
tests/test_stream.py's workloads (megablast, blastn, blastn-short,
vecscreen, two-hit with and without -off_diagonal_range, two-template
dc-megablast, tiny blocks, one
block, walks escalated across block edges, the database's mask and
index); streamed searches (split queries and -mode 2 among them) against
resident ones and against the JAX package's streamed searches; and the
choice of where a database lives. Exact equality throughout."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu.engine import stream as jstream
from gblastn_tpu.engine.search import search as jax_search
from gblastn_tpu.io.fasta import FastaRecord as JaxRecord
from gblastn_tpu.io.seqdb import SequenceDB as JaxDB
from gblastn_tpu.lut.dbindex import build_db_index as jax_build_index
from gblastn_tpu_torch.engine import stream as tstream
from gblastn_tpu_torch.engine.pipeline import run_pipelined_search
from gblastn_tpu_torch.engine.resident import SEARCH_WORK_BYTES
from gblastn_tpu_torch.engine.search import (
    device_matrix16,
    search,
    setup_batch,
)
from gblastn_tpu_torch.engine.seeding import run_seeding
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.lut.dbindex import build_db_index, save_db_index
from gblastn_tpu_torch.ops.ungapped import (
    make_table64,
    pack_query,
    ungapped_extend_window_ref,
)
from gblastn_tpu_torch.params.options import options_for_task
from gblastn_tpu_torch.utils.profiling import slog
from tests.test_torch_search import _jax_options, _rows

torch.set_num_threads(1)

BASES = "ACGT"
FIELDS = ("q_off", "s_off", "q_start", "s_start", "length", "score",
          "context", "oid")
STREAM_VARS = ("GBLASTN_TPU_STREAM", "GBLASTN_TPU_STREAM_THRESHOLD",
               "GBLASTN_TPU_BLOCK_BASES", "GBLASTN_TPU_BLOCK_HALO")


@pytest.fixture(autouse=True)
def _no_stream_vars(monkeypatch):
    for name in STREAM_VARS:
        monkeypatch.delenv(name, raising=False)


def _rand(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def _mutate(rng, s, rate):
    out = list(s)
    for i in range(len(out)):
        if rng.random() < rate:
            out[i] = BASES[rng.integers(0, 4)]
    return "".join(out)


@pytest.fixture(scope="module")
def problem():
    """tests/test_stream.py's: four subjects spanning many 1 kb blocks
    with matches planted on block boundaries (a 700-base exact match
    across the boundary at 4096, a mutated one inside a later block), and
    two queries."""
    rng = np.random.default_rng(42)
    q1 = _rand(rng, 800)
    q2 = _rand(rng, 500)
    s1 = _rand(rng, 3000)
    s2 = _rand(rng, 700) + q1[:700] + _rand(rng, 2500)
    s3 = _rand(rng, 1000) + _mutate(rng, q2, 0.04) + _rand(rng, 900)
    s4 = _rand(rng, 150)
    return ([("q0", "", q1), ("q1", "", q2)],
            [(f"s{i}", "", s) for i, s in enumerate((s1, s2, s3, s4))])


def _db(subjects):
    return SequenceDB.from_records([FastaRecord(*s) for s in subjects])


def _equal(got, want):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_block_plan_matches_jax(problem):
    """The plan's geometry, each block's packed buffer, its subjects'
    local bounds and its mask slice are the JAX package's (without its
    pow2 buckets)."""
    _q, subjects = problem
    db = _db(subjects)
    jdb = JaxDB.from_records([JaxRecord(*s) for s in subjects])
    ivs = np.array([[100, 900], [2000, 4500], [7000, 7010]], np.int64)
    for span, step, bb, halo in ((11, 1, 1024, 256), (12, 17, 4096, 512),
                                 (8, 4, 2000, 1000), (21, 1, 1 << 20, 4096)):
        got = tstream._BlockPlan(db, block_bases=bb, halo=halo, span=span,
                                 scan_step=step, mask_intervals=ivs)
        want = jstream._BlockPlan(jdb, block_bases=bb, halo=halo,
                                  lut_word=span, scan_step=step,
                                  mask_intervals=ivs)
        for name in ("B", "halo", "s_buf", "npos", "n_blocks", "slices",
                     "mask_slices"):
            assert getattr(got, name) == getattr(want, name), name
        for k in range(got.n_blocks):
            inp = want.block_inputs(jdb, k)
            assert got.has_work(k) == (inp is not None)
            if inp is None:
                continue
            buf, ls, le, p_lo, p_hi, _m = inp
            np.testing.assert_array_equal(got.packed(db, k), buf)
            lo, hi = got.bounds(k)
            np.testing.assert_array_equal(lo, ls[: len(lo)])
            np.testing.assert_array_equal(hi, le[: len(hi)])
            assert p_lo == got.halo
            assert got.halo + (got.n_scan(k) - 1) * step < p_hi
            assert got.halo + got.n_scan(k) * step >= p_hi


def test_host_extension_matches_k1_and_jax():
    """``ungapped_extend_host`` equals the JAX package's and K1's plain
    version with the true budgets, on random seeds of a planted read."""
    rng = np.random.default_rng(8)
    genome = _rand(rng, 5000)
    db = _db([("g", "", genome)])
    batch = setup_batch([FastaRecord("q", "", genome[1000:1600])], db,
                        options_for_task("megablast"), "cpu")
    query = batch.query.numpy()
    m16 = device_matrix16(1, -2)
    n = 64
    q_off = rng.integers(1, 1190, n).astype(np.int64)
    # half of them on the plus strand's diagonal (the buffer's first
    # context starts at 1)
    s_off = np.where(rng.random(n) < 0.5, q_off % 590 + 999,
                     rng.integers(0, 5000, n)).astype(np.int64)
    q_off = np.where(s_off == q_off % 590 + 999, q_off % 590, q_off)
    xd = np.full(n, 11, np.int32)
    sub_start = np.zeros(n, np.int64)
    sub_end = np.full(n, 5000, np.int64)
    got = tstream.ungapped_extend_host(query, m16, db.packed, sub_start,
                                       sub_end, q_off, s_off, xd)
    want = jstream.ungapped_extend_host(query, m16, db.packed, sub_start,
                                        sub_end, q_off, s_off, xd)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    max_l = np.minimum(q_off, s_off)
    max_r = np.minimum(len(query) - q_off, 5000 - s_off)
    t = [torch.from_numpy(a.astype(np.int32)) for a in (q_off, xd, max_l,
                                                         max_r)]
    k1 = ungapped_extend_window_ref(
        pack_query(batch.query), batch.seed_dev.resident.subject2,
        torch.from_numpy(make_table64(m16)), t[0], torch.from_numpy(s_off),
        t[1], t[2], t[3])
    for g, w in zip(got, k1[:4]):
        np.testing.assert_array_equal(g, w.numpy())
    assert (got[3] > 500).sum() >= 20       # the planted read's seeds


def test_unpack_range_matches_jax():
    rng = np.random.default_rng(9)
    db = _db([("g", "", _rand(rng, 4000))])
    full = db.unpacked()
    for p0, p1 in [(0, 10), (3, 17), (127, 131), (3998, 3999), (0, 3999)]:
        np.testing.assert_array_equal(tstream.unpack_range(db.packed, p0, p1),
                                      full[p0:p1])
        np.testing.assert_array_equal(
            jstream.unpack_range(db.packed, p0, p1), full[p0:p1])


def test_block_index_slices_match_jax(problem):
    """Each block's index slice holds the JAX package's words and local
    positions (without its padding), and the slices partition the
    index."""
    _q, subjects = problem
    db = _db(subjects)
    jdb = JaxDB.from_records([JaxRecord(*s) for s in subjects])
    index = build_db_index(db, 11)
    jindex = jax_build_index(jdb, 11)
    step = index.word_size - index.lut_word + 1
    got_plan = tstream._BlockPlan(db, block_bases=2048, halo=256,
                                  span=index.lut_word, scan_step=step,
                                  mask_intervals=None)
    want_plan = jstream._BlockPlan(jdb, block_bases=2048, halo=256,
                                   lut_word=index.lut_word, scan_step=step)
    got = tstream._block_index_slices(db, index, got_plan)
    want = jstream._block_index_slices(jdb, jindex, want_plan)
    assert len(got) == len(want) > 2
    for (words, pos), (wp, pp, n) in zip(got, want):
        np.testing.assert_array_equal(words, wp[:n])
        np.testing.assert_array_equal(pos, pp[:n])
    assert sum(len(p) for _w, p in got) == len(index.positions)


def _streamed(reads, db, opts, monkeypatch, block_bases, halo):
    """The resident InitHits, the streamed InitHits, the streamed run's
    slog values and its StreamedDB, of one batch."""
    recs = [FastaRecord(*r) for r in reads]
    ref = setup_batch(recs, db, opts, "cpu")
    assert ref.stream is None
    want = run_seeding(ref.seed_dev, **ref.seed_kw)
    monkeypatch.setenv("GBLASTN_TPU_STREAM", "1")
    monkeypatch.setenv("GBLASTN_TPU_BLOCK_BASES", str(block_bases))
    monkeypatch.setenv("GBLASTN_TPU_BLOCK_HALO", str(halo))
    b = setup_batch(recs, db, opts, "cpu")
    assert b.stream is not None and b.seed_dev.resident is None
    slog.reset()
    got = tstream.run_seeding_streamed(b.stream, b.seed_dev, **b.seed_kw)
    monkeypatch.delenv("GBLASTN_TPU_STREAM")
    return want, got, dict(slog.values), b.stream


CASES = {
    # name: (task, options, block bases, halo)
    "megablast": ("megablast", {"lut_word_size": 11}, 4096, 512),
    "blastn": ("blastn", {}, 4096, 512),
    "two_hit": ("blastn", {"window_size": 40}, 4096, 512),
    "two_hit_rr": ("megablast", {"window_size": 40}, 4096, 512),
    "off_diagonal": ("blastn", {"window_size": 40,
                                "off_diagonal_range": 4}, 2048, 256),
    "disc_two_templates": ("dc-megablast",
                           {"template_type": "coding_and_optimal"},
                           2048, 256),
    "tiny_blocks": ("blastn", {}, 1024, 256),
    "blastn_short": ("blastn-short", {}, 2048, 256),
    "vecscreen": ("vecscreen", {}, 2048, 256),
    "one_block": ("megablast", {}, 1 << 20, 1024),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_equals_resident(problem, monkeypatch, case):
    """Streamed seeding gives the resident path's InitHits, field by
    field, with every walk across a block edge escalated on the host
    where the blocks are small."""
    task, kw, bb, halo = CASES[case]
    reads, subjects = problem
    db = _db(subjects)
    opts = options_for_task(task, evalue=1e-3, **kw)
    want, got, values, sdb = _streamed(reads, db, opts, monkeypatch, bb,
                                       halo)
    plan = sdb.plan
    _equal(got, want)
    assert len(got) > 0
    assert values["seeding.stream_blocks"] == sum(
        plan.has_work(k) for k in range(plan.n_blocks))
    if case == "tiny_blocks":
        # the 700-base exact match across the boundary at 4096
        assert values["seeding.stream_escalated"] > 0
    if case == "one_block":
        assert plan.n_blocks == 1


@pytest.mark.parametrize("what", ["mask", "index", "index_mask"])
def test_streamed_mask_and_index(problem, monkeypatch, tmp_path, what):
    """The database's soft mask (intervals clipped per block) and its
    index (sliced by block ownership): streamed InitHits equal the
    resident ones."""
    reads, subjects = problem
    db = _db(subjects)
    kw = {"evalue": 1e-3}
    if what != "index":
        db.add_mask_set(10, "dust", "test",
                        {"s1": [(600, 1500)], "s2": [(0, 200), (3900, 4000)]})
        kw["db_soft_mask"] = 10
    if what != "mask":
        db._source_path = str(tmp_path / "db")
        save_db_index(build_db_index(db, 28, 12), str(tmp_path / "db"))
        kw.update(use_index=True, lut_word_size=12)
    opts = options_for_task("megablast", **kw)
    want, got, _values, sdb = _streamed(reads, db, opts, monkeypatch, 1024,
                                        256)
    _equal(got, want)
    assert len(got) > 0
    assert (sdb.index_slices is None) == (what == "mask")
    assert (sdb.plan.mask_slices is None) == (what == "index")


def test_walk_escalated_across_a_block_edge(monkeypatch):
    """A 3 kb exact read whose alignment spans three blocks of 1024
    bases: its seeds' walks stop at their buffers' edges, the host
    re-extends them, and the InitHits equal the resident ones (the whole
    read as one extension)."""
    rng = np.random.default_rng(3)
    genome = _rand(rng, 12000)
    db = _db([("g", "", genome)])
    reads = [("long", "", genome[3500:6500])]
    want, got, values, _sdb = _streamed(
        reads, db, options_for_task("blastn", evalue=1e-3), monkeypatch,
        1024, 256)
    _equal(got, want)
    assert values["seeding.stream_escalated"] > 0
    assert int(got.length.max()) == 3000


def _search_rows(reads, db, opts):
    return _rows(search([FastaRecord(*r) for r in reads], db, opts,
                        device="cpu"))


def test_streamed_search_matches_jax(monkeypatch):
    """A streamed search equals the resident one and the JAX package's
    streamed search, on test_stream.py's end-to-end workloads (megablast
    over blocks of 2048; coding_and_optimal dc-megablast over blocks of
    4096)."""
    rng = np.random.default_rng(5)
    genome = _rand(rng, 20000)
    reads = [("r1", "", _mutate(rng, genome[3000:3400], 0.02)),
             ("r2", "", genome[9000:9800]), ("r3", "", _rand(rng, 300))]
    rng = np.random.default_rng(71)
    genome2 = _rand(rng, 24000)

    def wobble(seg, seed):
        r = np.random.default_rng(seed)
        out = list(seg)
        for pp in range(2, len(out), 3):
            if r.random() < 0.4:
                out[pp] = BASES[(BASES.index(out[pp]) + 1
                                 + r.integers(0, 3)) % 4]
        return "".join(out)

    reads2 = [("d1", "", wobble(genome2[3000:3700], 1)),
              ("d2", "", wobble(genome2[19000:19500], 2))]
    for g, rs, task, kw, bb in (
            (genome, reads, "megablast", {}, 2048),
            (genome2, reads2, "dc-megablast",
             {"evalue": 1e-3, "template_type": "coding_and_optimal"},
             4096)):
        subjects = [("chr", "", g)]
        resident = _search_rows(rs, _db(subjects), options_for_task(task,
                                                                    **kw))
        monkeypatch.setenv("GBLASTN_TPU_STREAM", "1")
        monkeypatch.setenv("GBLASTN_TPU_BLOCK_BASES", str(bb))
        monkeypatch.setenv("GBLASTN_TPU_BLOCK_HALO", "512")
        got = _search_rows(rs, _db(subjects), options_for_task(task, **kw))
        want = _rows(jax_search(
            [JaxRecord(*r) for r in rs],
            JaxDB.from_records([JaxRecord(*s) for s in subjects]),
            _jax_options(task, **kw)))
        for name in STREAM_VARS:
            monkeypatch.delenv(name, raising=False)
        assert got == resident == want and len(got) >= 2


def test_streamed_split_query_and_mode2(problem, monkeypatch):
    """A query split into chunks, and -mode 2's pipeline over two
    batches, give the resident results when the database streams."""
    reads, subjects = problem
    db = _db(subjects)
    opts = options_for_task("blastn", evalue=1e-3)
    monkeypatch.setenv("CHUNK_SIZE", "500")
    want_split = _search_rows(reads, db, opts)
    want = []
    run_pipelined_search(iter([[FastaRecord(*reads[0])],
                               [FastaRecord(*reads[1])]]), db, opts,
                         want.append, device="cpu")
    monkeypatch.setenv("GBLASTN_TPU_STREAM", "1")
    monkeypatch.setenv("GBLASTN_TPU_BLOCK_BASES", "2048")
    monkeypatch.setenv("GBLASTN_TPU_BLOCK_HALO", "256")
    db2 = _db(subjects)
    assert _search_rows(reads, db2, opts) == want_split
    monkeypatch.delenv("CHUNK_SIZE")
    got = []
    run_pipelined_search(iter([[FastaRecord(*reads[0])],
                               [FastaRecord(*reads[1])]]), db2, opts,
                         got.append, device="cpu")
    assert [_rows(r) for r in got] == [_rows(r) for r in want]
    assert not hasattr(db2, "_torch_resident")      # never uploaded


def test_stream_decision():
    """Forced, forbidden, fits, does not fit and the threshold;
    MemoryError names both numbers. The streamed need is one block's
    forms, the build chunk, the subject bounds and the streamed working
    memory, with no cache and no blocks in flight."""
    kw = dict(padded_length=1000, resident_need=500, stream_need=300)
    dec = tstream.stream_decision
    assert dec(env="1", threshold=None, free=None, **kw)[0]
    assert dec(env="1", threshold=None, free=400, **kw)[0]
    with pytest.raises(MemoryError, match="needs 300 bytes.* 200 free"):
        dec(env="1", threshold=None, free=200, **kw)
    assert not dec(env="0", threshold=None, free=None, **kw)[0]
    assert not dec(env="0", threshold=None, free=600, **kw)[0]
    with pytest.raises(MemoryError, match="need 500 bytes.* 400 free"):
        dec(env="0", threshold=None, free=400, **kw)
    assert not dec(env="", threshold=None, free=None, **kw)[0]
    assert not dec(env="", threshold=None, free=500, **kw)[0]
    streams, reason = dec(env="", threshold=None, free=499, **kw)
    assert streams and "500" in reason and "499" in reason
    with pytest.raises(MemoryError, match="needs 300 bytes.* 299 free"):
        dec(env="", threshold=None, free=299, **kw)
    assert dec(env="", threshold=999, free=None, **kw)[0]
    assert not dec(env="", threshold=1000, free=None, **kw)[0]
    plan = tstream._BlockPlan(_db([("g", "", "ACGT" * 100)]),
                              block_bases=1 << 27, halo=4096, span=12,
                              scan_step=17)
    need = tstream.stream_bytes(plan, 7)
    assert need == (int(plan.s_buf * 2.75) + 16 * (plan.s_buf // 4 + 1)
                    + 16 * 7 + tstream.STREAM_WORK_BYTES)
    assert need < SEARCH_WORK_BYTES


def test_choose_keeps_a_resident_form(monkeypatch):
    """A database whose resident form is on the device stays resident
    unless streaming is forced; a forced stream on the CPU has the whole
    cache budget."""
    db = _db([("g", "", "ACGT" * 300)])
    kw = dict(span=11, scan_step=1, mask_intervals=None, db_index=None,
              matrix16=device_matrix16(1, -2), query=np.zeros(8, np.uint8))
    cpu = torch.device("cpu")
    db._torch_resident = {cpu: object()}
    assert tstream.choose(db, cpu, **kw) is None
    monkeypatch.setenv("GBLASTN_TPU_STREAM", "1")
    sdb = tstream.choose(db, cpu, **kw)
    assert sdb is not None and sdb.cache_budget == tstream.CACHE_BYTES


@pytest.mark.parametrize("tables", ["batch", "walks_to_the_edge"])
def test_gate_walks_cut_by_the_buffer_are_escalated(tables):
    """G over a block (its walks clipped to the buffer) against G over
    the whole database: every seed whose gate result differs is among
    ``_edge_walks``' G edges. With no X-drop and an unreachable reduced
    cutoff every walk runs to its budget and every seed is demoted, so
    the walks the buffer cuts differ, and must all be flagged."""
    from gblastn_tpu_torch.ops.replay import approx_gate_ref

    rng = np.random.default_rng(4)
    genome = _rand(rng, 6000)
    db = _db([("g", "", genome)])
    batch = setup_batch([FastaRecord("q", "", genome[1000:4500])], db,
                        options_for_task("blastn"), "cpu")
    dev, res = batch.seed_dev, batch.seed_dev.resident
    ctx_tables = dev.ctx_tables.clone()
    if tables == "walks_to_the_edge":
        ctx_tables[1] = 1 << 20          # reduced cutoff: every seed demotes
        ctx_tables[2] = 1 << 20          # x_drop: no walk drops
    plan = tstream._BlockPlan(db, block_bases=1024, halo=256, span=11,
                              scan_step=1)
    k = 2
    g0 = plan.slices[k][0]
    n = 400
    s_g = rng.integers(k * plan.B, (k + 1) * plan.B, n).astype(np.int64)
    # most on the read's diagonal (plus strand from buffer offset 1),
    # the rest anywhere in the read
    q = np.where(rng.random(n) < 0.7, s_g - 1000 + 1,
                 rng.integers(1, 3490, n)).astype(np.int64)
    q32 = torch.from_numpy(q.astype(np.int32))
    ctx = torch.zeros(n, dtype=torch.int32)
    oid = torch.zeros(n, dtype=torch.int32)
    ss = torch.from_numpy(s_g)
    rows = (q32, ss, torch.full((n,), 11, dtype=torch.int32),
            torch.full((n,), 1000, dtype=torch.int32))
    kw = dict(word_size=11, concat_end=3501)
    want = approx_gate_ref(dev.qbytes, res.packed, dev.table256, ctx_tables,
                           res.starts, res.ends, q32, ss, ctx, oid, *rows,
                           **kw)
    lo, hi = (torch.from_numpy(b) for b in plan.bounds(k))
    packed = torch.from_numpy(plan.packed(db, k))
    got = approx_gate_ref(dev.qbytes, packed, dev.table256, ctx_tables,
                          lo.clamp(0, plan.s_buf), hi.clamp(0, plan.s_buf),
                          q32, ss - g0, ctx, oid, rows[0], rows[1] - g0,
                          rows[2], rows[3], **kw)
    differ = ((got[0] != want[0]) | (got[1] + g0 != want[1])
              | (got[2] != want[2]) | (got[3] != want[3]))
    zero = torch.zeros(n, dtype=torch.int32)
    k1_args = (torch.zeros(3502, dtype=torch.uint8), None, None, q32,
               ss - g0, zero, zero, zero)
    edge = tstream._edge_walks(k1_args, (*rows, zero), (None,) * 9 + (oid,),
                               got[4], lo, hi, s_buf=plan.s_buf,
                               concat_end=3501)
    assert not (differ & (edge & 2 == 0)).any()
    if tables == "walks_to_the_edge":
        assert differ.sum() >= 20
    else:
        # only demoted seeds escalate: the random ones (their faked exact
        # score passes, their approximate one does not), never the read's
        flagged = edge & 2 != 0
        assert flagged.any()
        assert not (flagged & ((got[4] & 2) == 0)).any()
        assert not flagged[torch.from_numpy(q == s_g - 999)].any()
