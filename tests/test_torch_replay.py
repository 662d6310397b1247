"""The device finish of one-hit seeding (ops/replay.py) on the CPU: the
plain versions of the approximate-ungapped gate G and the one-hit replay R
against the host twins (native and Python) and against the JAX package's
``approx_gate_device`` and ``diag_replay_device``, and ``run_seeding``
against the host finish ``_finish_init_hits``. Inputs come from seeded
numpy generators; every comparison is exact."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gblastn_tpu.ops.seeding import approx_gate_device, diag_replay_device
from gblastn_tpu.ops.seeding import pack_subject_words as jax_pack_words
from gblastn_tpu_torch import FastaRecord, SequenceDB
from gblastn_tpu_torch.engine.approx import compute_approx_info
from gblastn_tpu_torch.engine.search import setup_batch
from gblastn_tpu_torch.engine.seeding import (
    _finish_init_hits,
    diag_table_mask,
    one_hit_diag_filter,
    run_seeding,
    ungapped_inputs,
)
from gblastn_tpu_torch.ops import replay as rp
from gblastn_tpu_torch.ops.ungapped import ungapped_extend_window
from gblastn_tpu_torch.params.derived import nucl_score_table_packed
from gblastn_tpu_torch.params.options import blastn_options, megablast_options
from gblastn_tpu_torch.tools.replay_sets import key_bounds

# the plain versions run many small ops: on the CPU one thread beats a pool
torch.set_num_threads(1)

WORD = 11


def _t(a, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dt is None else t.to(dt)


def _gate_fixture(seed, n=1500):
    """Three subjects (pad-aligned starts), a query with planted matches,
    N (14), R (4) and sentinels (15); seeds at random and on the planted
    matches, some at subject ends; two contexts with their own cutoff,
    reduced cutoff and x_drop. Returns (db, query, seeds, ctx_tables,
    concat_end) with seeds = dict of int64 arrays (q, s, ctx, oid, and
    the rows ug_q, ug_s, ug_len, ug_score)."""
    rng = np.random.default_rng(seed)
    recs = [FastaRecord(f"s{i}", "", "".join(
        "ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1500, 4000)))))
        for i in range(3)]
    db = SequenceDB.from_records(recs, title="gate")
    sub2 = db.unpacked()
    starts = np.asarray(db.starts, np.int64)
    ends = starts + np.asarray(db.lengths, np.int64)
    Q = 4096
    query = rng.integers(0, 4, Q).astype(np.uint8)
    plants = []
    for _ in range(30):
        o = int(rng.integers(0, 3))
        L = int(rng.integers(50, 400))
        sp = int(rng.integers(starts[o], ends[o] - L))
        qp = int(rng.integers(8, Q - L - 8))
        query[qp: qp + L] = sub2[sp: sp + L]
        plants.append((qp, sp, L, o))
    query[rng.integers(1, Q - 1, 25)] = 14
    query[rng.integers(1, Q - 1, 10)] = 4
    query[::509] = 15
    query[0] = query[-1] = 15
    oid = rng.integers(0, 3, n)
    s = starts[oid] + (rng.random(n) * db.lengths[oid]).astype(np.int64)
    q = rng.integers(1, Q - 2, n).astype(np.int64)
    for k in range(0, n, 2):              # half on the planted matches
        qp, sp, L, o = plants[int(rng.integers(0, len(plants)))]
        d = int(rng.integers(0, L))
        q[k], s[k], oid[k] = qp + d, sp + d, o
    s[1::50] = ends[oid[1::50]] - rng.integers(1, 6, len(s[1::50]))
    s[3::50] = starts[oid[3::50]] + rng.integers(0, 3, len(s[3::50]))
    ctx = (rng.random(n) < 0.5).astype(np.int64)
    ug_q = q - rng.integers(0, 30, n)
    ug_s = s - (q - ug_q)
    ug_len = (q - ug_q) + rng.integers(WORD, 200, n)
    ug_score = rng.integers(10, 60, n)
    # word cutoff, reduced cutoff, x_drop per context
    ctx_tables = np.array([[25, 30], [22, 27], [20, 16]], np.int32)
    seeds = dict(q=q, s=s, ctx=ctx, oid=oid.astype(np.int64), ug_q=ug_q,
                 ug_s=ug_s, ug_len=ug_len, ug_score=ug_score)
    return db, query, seeds, ctx_tables, Q - 1


def _gate_ref(db, query, sd, ctx_tables, concat_end, table):
    starts = np.asarray(db.starts, np.int64)
    ends = starts + np.asarray(db.lengths, np.int64)
    return rp.approx_gate(
        rp.query_bytes(_t(query)), _t(db.packed_padded()),
        _t(table, torch.int32),
        _t(ctx_tables), _t(starts), _t(ends),
        *(_t(sd[k], torch.int32) for k in ("q", "s", "ctx", "oid", "ug_q",
                                           "ug_s", "ug_len", "ug_score")),
        word_size=WORD, concat_end=concat_end)


def test_query_bytes_truncated_packing():
    """query_bytes packs each position's four codes as the reference's C
    does, ((q0<<6)|(q1<<4)|(q2<<2)|q3) & 0xFF into uint8, ambiguity codes
    (14, 15) bleeding into the neighbouring slots; under four codes
    there is no byte."""
    rng = np.random.default_rng(41)
    q = rng.integers(0, 16, 300).astype(np.uint8)
    q32 = q.astype(np.int64)
    want = ((q32[:-3] << 6) | (q32[1:-2] << 4) | (q32[2:-1] << 2)
            | q32[3:]) & 0xFF
    got = rp.query_bytes(_t(q))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert rp.query_bytes(_t(q[:3])).numel() == 0


def _host_substitution(db, query, sd, ctx_tables, concat_end, table,
                       use_native):
    """What _finish_init_hits does with compute_approx_info's verdicts:
    (rows after the substitution, demote, need)."""
    starts = np.asarray(db.starts, np.int64)
    ends = starts + np.asarray(db.lengths, np.int64)
    need = sd["ug_score"] >= ctx_tables[0][sd["ctx"]]
    dem, a_sc, a_q, a_s, a_r = compute_approx_info(
        query, concat_end, db.packed, starts[sd["oid"]], ends[sd["oid"]],
        sd["q"], sd["s"], sd["ctx"].astype(np.int32), ctx_tables[2],
        ctx_tables[1].astype(np.int64), table, need, use_native=use_native)
    rows = [sd[k].copy() for k in ("ug_q", "ug_s", "ug_len", "ug_score")]
    rows[0][dem] = a_q[dem]
    rows[1][dem] = a_s[dem]
    rows[2][dem] = np.maximum(sd["s"][dem] + WORD - a_s[dem],
                              a_r[dem] - a_q[dem] + 1)
    rows[3][dem] = a_sc[dem]
    return rows, dem, need


@pytest.mark.parametrize("seed", [823, 824])
@pytest.mark.parametrize("use_native", [True, False])
def test_gate_matches_host_twin(seed, use_native):
    """G's plain version equals compute_approx_info (and the
    substitution _finish_init_hits makes) on every seed, with ambiguity
    codes, subject ends and two contexts."""
    db, query, sd, tabs, cend = _gate_fixture(seed)
    table = nucl_score_table_packed(1, -2)
    *got, flags = _gate_ref(db, query, sd, tabs, cend, table)
    want, dem, need = _host_substitution(db, query, sd, tabs, cend, table,
                                         use_native)
    f = flags.numpy()
    np.testing.assert_array_equal((f & rp.FLAG_NEED) != 0, need)
    np.testing.assert_array_equal((f & rp.FLAG_DEMOTE) != 0, dem)
    assert not (f & rp.FLAG_RANGE).any()
    assert 0 < dem.sum() < need.sum()                 # non-vacuous
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _repeat_fixture():
    """A long perfect repeat (a 4-base unit tiled over subject and
    query, phase-matched seeds): walks of hundreds of byte-steps, which
    the JAX package's 48-byte clamp leaves unresolved."""
    rng = np.random.default_rng(900)
    unit = "".join("ACGT"[c] for c in rng.integers(0, 4, 4))
    db = SequenceDB.from_records([FastaRecord("rep", "", unit * 1024)],
                                 title="rep")
    Q = 2048
    query = np.zeros(Q, np.uint8)
    query[0] = query[-1] = 15
    codes = np.array(["ACGT".index(c) for c in unit], np.uint8)
    query[1:-1] = np.tile(codes, Q // 4)[: Q - 2]
    n = 64
    q = np.full(n, Q // 2 + 1, np.int64)
    s = (np.arange(n) * 8 + 2048).astype(np.int64)
    z = np.zeros(n, np.int64)
    sd = dict(q=q, s=s, ctx=z, oid=z, ug_q=q - 5, ug_s=s - 5,
              ug_len=np.full(n, 40, np.int64), ug_score=np.full(n, 40))
    # cutoff 30 (every seed gated), reduced 10,000 (never reached)
    tabs = np.array([[30], [10_000], [22]], np.int32)
    return db, query, sd, tabs, Q - 1


@pytest.mark.parametrize("use_native", [True, False])
def test_gate_resolves_the_long_repeat(use_native):
    """The unclamped gate walks the long repeat to its end and equals the
    host twin: every seed demoted with the walk's whole extent."""
    db, query, sd, tabs, cend = _repeat_fixture()
    table = nucl_score_table_packed(1, -2)
    *got, flags = _gate_ref(db, query, sd, tabs, cend, table)
    want, dem, _need = _host_substitution(db, query, sd, tabs, cend, table,
                                           use_native)
    assert dem.all()
    assert int(got[2].min()) > 1000                  # the walks' extent
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_gate_matches_jax_where_resolved():
    """G's plain version against JAX's approx_gate_device on the seeds
    that the JAX clamp resolves: the same demotions, and on the demoted
    seeds the same approximate score and extension."""
    db, query, sd, tabs, cend = _gate_fixture(825)
    table = nucl_score_table_packed(1, -2)
    *got, flags = _gate_ref(db, query, sd, tabs, cend, table)
    starts = np.asarray(db.starts, np.int64)
    ends = starts + np.asarray(db.lengths, np.int64)
    need = sd["ug_score"] >= tabs[0][sd["ctx"]]
    q32 = query.astype(np.int32)
    qbytes = ((q32[:-3] << 6) | (q32[1:-2] << 4) | (q32[2:-1] << 2)
              | q32[3:]) & 0xFF
    j = jnp.asarray
    i32 = jnp.int32
    dem, a_q, a_s, a_end, total, resolved = (np.asarray(o) for o in
                                             approx_gate_device(
        j(qbytes, i32), jax_pack_words(j(db.packed_padded())),
        j(table, i32), j(sd["q"], i32), j(sd["s"], i32), j(need),
        j(tabs[2][sd["ctx"]], i32), j(tabs[1][sd["ctx"]], i32),
        j(starts[sd["oid"]], i32), j(ends[sd["oid"]], i32), i32(cend)))
    r = resolved & need
    assert r.sum() > 0.9 * need.sum()
    f = flags.numpy()
    np.testing.assert_array_equal(((f & rp.FLAG_DEMOTE) != 0)[r], dem[r])
    d = np.nonzero(dem & r)[0]
    assert len(d) > 0
    np.testing.assert_array_equal(got[3].numpy()[d], total[d])
    np.testing.assert_array_equal(got[0].numpy()[d], a_q[d])
    np.testing.assert_array_equal(got[1].numpy()[d], a_s[d])


def test_gate_flags_reads_out_of_range():
    """A seed whose walk would read past the query buffer, or whose
    subject or context index is out of range, gets FLAG_RANGE and keeps
    its rows; check_gate_flags raises ValueError."""
    db, query, sd, tabs, cend = _gate_fixture(826, n=64)
    sd["ug_score"][:] = 50                          # every seed gated
    sd["oid"][3] = 7
    sd["ctx"][5] = 2
    table = nucl_score_table_packed(1, -2)
    *got, flags = _gate_ref(db, query, sd, tabs, cend + 100, table)
    f = flags.numpy()
    assert f[3] == rp.FLAG_NEED | rp.FLAG_RANGE
    assert f[5] == rp.FLAG_RANGE
    assert (f & rp.FLAG_RANGE).sum() > 2           # the long query end
    bad = (f & rp.FLAG_RANGE) != 0
    for g, k in zip(got, ("ug_q", "ug_s", "ug_len", "ug_score")):
        np.testing.assert_array_equal(g.numpy()[bad], sd[k][bad])
    with pytest.raises(ValueError, match="outside"):
        rp.check_gate_flags(flags)


def _replay(q, s, oid, end, score, cutoff, word, diag_mask):
    """R's plain version on numpy seeds (subject-local s): the saved
    mask."""
    bounds = key_bounds(q, s, oid)
    q, s, oid, end, score, cutoff = (_t(a, torch.int32) for a in (
        q, s, oid, end, score, cutoff))
    key, order, shift = rp.replay_keys(q, s, oid, diag_mask, **bounds)
    return rp.diag_replay(key, order, s, end, score, cutoff, word_size=word,
                          key_shift=shift).numpy().astype(bool)


def _replay_case(rng, n, *, word, n_oid=3, chain_max=30, dup=0.0):
    """Chains of seeds sharing an (oid, diagonal), spaced about a word
    apart (skips, saves and failures all occur), shuffled; ``dup`` of
    them repeated verbatim (identical seeds). Subject-local s."""
    q = np.zeros(n, np.int64)
    s = np.zeros(n, np.int64)
    oid = np.zeros(n, np.int64)
    i = 0
    while i < n:
        o = int(rng.integers(0, n_oid))
        d = int(rng.integers(0, 3000))
        q0 = int(rng.integers(1, 500))
        pos = q0 + d
        for _ in range(min(int(rng.integers(1, chain_max)), n - i)):
            q[i], s[i], oid[i] = pos - d, pos, o
            i += 1
            pos += int(rng.integers(1, 2 * word + 10))
    k = int(dup * n)
    if k:
        src = rng.integers(0, n, k)
        dst = rng.integers(0, n, k)
        q[dst], s[dst], oid[dst] = q[src], s[src], oid[src]
    score = rng.integers(0, 44, n)
    cutoff = np.full(n, 22)
    l_ext = rng.integers(0, 10, n)
    length = l_ext + word + rng.integers(0, 40, n)
    length[::17] = 0                                # end at the seed
    ug_s = s - l_ext
    perm = rng.permutation(n)
    return tuple(a[perm] for a in (q, s, oid, ug_s, length, score, cutoff))


@pytest.mark.parametrize("word,diag_mask,chain_max,dup", [
    (28, 0, 30, 0.0),
    (11, 127, 30, 0.05),                            # aliasing mask
    (28, diag_table_mask(4000, 0), 200, 0.02),      # long chains
])
def test_replay_matches_host_twin_and_jax(word, diag_mask, chain_max, dup):
    """R's plain version equals one_hit_diag_filter (native and Python)
    and JAX's diag_replay_device(window=0)."""
    rng = np.random.default_rng(720 + chain_max + word)
    q, s, oid, ug_s, length, score, cutoff = _replay_case(
        rng, 3000, word=word, chain_max=chain_max, dup=dup)
    got = _replay(q, s, oid, ug_s + length, score, cutoff, word, diag_mask)
    args = [a.astype(np.int32) for a in (q, s, oid, ug_s, length, score,
                                         cutoff)]
    for native in (True, False):
        want = one_hit_diag_filter(*args[:3], word, *args[3:],
                                   use_native=native, diag_mask=diag_mask)
        np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    j = jnp.asarray
    saved, n_ovf = diag_replay_device(
        j(args[0]), j(args[1]), j(np.ones(len(q), bool)),
        j(np.zeros(len(q), np.int32)), j(args[2]),
        j((ug_s + length).astype(np.int32)), j(args[5]), j(args[6]),
        word_size=word, window=0, diag_mask=diag_mask)
    assert int(n_ovf) == 0
    np.testing.assert_array_equal(got, np.asarray(saved))


def test_replay_dense_chain_and_ties():
    """A dense chain (one seed every base on one diagonal, failing, then
    one saving seed) and identical seeds: the first of two identical
    seeds in index order is taken, the second skipped, as the stable
    host order gives."""
    n = 400
    s = np.arange(n, dtype=np.int64) + 100
    q = s - 50
    z = np.zeros(n, np.int64)
    score = np.zeros(n, np.int64)
    score[198] = 99                  # s = 298 = 100 + 18 words: processed
    end = s + 5
    end[198] = 350
    # a duplicate of seed 198 at the end: skipped (s < last_hit)
    q, s, z2, end2, score2 = (np.append(a, a[198]) for a in
                              (q, s, z, end, score))
    cut = np.full(n + 1, 22)
    got = _replay(q, s, z2, end2, score2, cut, 11, 0)
    want = one_hit_diag_filter(
        q.astype(np.int32), s.astype(np.int32), z2.astype(np.int32), 11,
        end2.astype(np.int32), np.zeros(n + 1, np.int32),
        score2.astype(np.int32), cut.astype(np.int32), use_native=False)
    np.testing.assert_array_equal(got, want)
    assert got[198] and not got[n] and got.sum() == 1


def _batch(task):
    """A small batch of each task on the CPU: reads with substitutions
    from two subjects, one reverse-complemented, one with N."""
    rng = np.random.default_rng(7 if task == "megablast" else 8)
    g = ["".join("ACGT"[c] for c in rng.integers(0, 4, L))
         for L in (30000, 9000)]
    db = SequenceDB.from_records(
        [FastaRecord(f"g{i}", "", x) for i, x in enumerate(g)], title="t")
    reads = []
    for k in range(6):
        src = g[k % 2]
        st = int(rng.integers(0, len(src) - 700))
        r = list(src[st: st + 600])
        for p in np.flatnonzero(rng.random(600) < 0.03):
            r[p] = "ACGT"[("ACGT".index(r[p]) + 1) % 4]
        if k == 2:
            r[300] = "N"
        seq = "".join(r)
        if k == 3:
            seq = seq[::-1].translate(str.maketrans("ACGTN", "TGCAN"))
        reads.append(FastaRecord(f"r{k}", "", seq))
    opts = (megablast_options if task == "megablast" else blastn_options)(
        evalue=1e-5)
    return setup_batch(reads, db, opts, "cpu")


@pytest.mark.parametrize("task", ["megablast", "blastn"])
def test_run_seeding_matches_host_finish(task):
    """run_seeding (the device finish, plain versions on the CPU) gives
    InitHits equal field by field to _finish_init_hits on the full rows
    of K1's outputs."""
    batch = _batch(task)
    kw, okw = batch.seed_kw, batch.oracle_kw
    got = run_seeding(batch.seed_dev, **kw)
    ctx, k1_args, _n = ungapped_inputs(batch.seed_dev, **kw)
    uq, us, ulen, usc, _f = ungapped_extend_window(*k1_args)
    n_ctx = len(kw["x_dropoffs"])
    want = _finish_init_hits(
        *(t.numpy() for t in (k1_args[3], k1_args[4], ctx.to(torch.int32),
                              uq, us, ulen, usc)),
        okw["word_cutoffs"], okw["subject_starts"], kw["word_size"],
        concat_qlen=int(kw["context_offsets"][n_ctx]) - 2,
        approx_ctx=okw["approx_ctx"])
    assert len(got) > 5
    for name in ("q_off", "s_off", "q_start", "s_start", "length", "score",
                 "context", "oid"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_cuda_tensors_never_reach_the_plain_versions():
    """A wrapper given a tensor on a device with no kernel raises; there
    is no fallback to the plain version."""
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rp.diag_replay(z.long(), z.long(), z, z, z, z, word_size=11)
