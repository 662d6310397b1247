"""gblastn_tpu_torch.ops.seeding against gblastn_tpu.ops.seeding.

The port returns exact-size arrays; the JAX functions return fixed-size
lanes with a fill mask. The port's outputs must equal the JAX outputs'
filled lanes, in order. Integer outputs, compared exactly."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gblastn_tpu.io.fasta import FastaRecord
from gblastn_tpu.io.query import build_query_block
from gblastn_tpu.io.seqdb import SequenceDB
from gblastn_tpu.lut.builder import build_lookup_table, unmasked_locations
from gblastn_tpu.ops import seeding as jx
from gblastn_tpu_torch.ops import seeding as pt

# the plain versions run many small ops: on the CPU one thread beats a pool
torch.set_num_threads(1)


def _rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def packed_problem():
    """tests/test_seeding.py TestMiniExtendPacked: 3 subjects, a 4096
    query with sentinels, an N and 40 planted subject stretches."""
    rng = np.random.default_rng(0)
    recs = []
    for i in range(3):
        n = int(rng.integers(300, 2000))
        recs.append(FastaRecord(f"s{i}", "", _rand_seq(rng, n)))
    db = SequenceDB.from_records(recs, title="t")
    q = rng.integers(0, 4, 4096).astype(np.uint8)
    q[::311] = 15
    q[100] = 14
    sub2 = db.unpacked()
    plants = []
    for _ in range(40):
        so = int(rng.integers(40, db.padded_length - 80))
        qo = int(rng.integers(40, 4096 - 80))
        q[qo: qo + 60] = sub2[so: so + 60]
        plants.append((qo, so))
    return db, q, rng, plants


def test_packing_matches_jax(packed_problem):
    db, q, _, _ = packed_problem
    np.testing.assert_array_equal(
        pt.pack_query_nibbles(_t(q)).numpy(),
        np.asarray(jx.pack_query_nibbles(jnp.asarray(q))).astype(np.int64),
    )
    for packed in (db.packed, db.packed[:-1]):   # odd byte count pads
        np.testing.assert_array_equal(
            pt.pack_subject_words(_t(packed)).numpy(),
            np.asarray(jx.pack_subject_words(jnp.asarray(packed))).astype(
                np.int64),
        )
    starts = np.asarray(db.starts)
    ends = starts + np.asarray(db.lengths)
    np.testing.assert_array_equal(
        pt.unpack_2na(_t(db.packed)).numpy(),
        np.asarray(jx.unpack_2na_device(jnp.asarray(db.packed))),
    )
    S = db.padded_length
    np.testing.assert_array_equal(
        pt.valid_from_intervals(S, _t(starts), _t(ends)).numpy(),
        np.asarray(jx.valid_from_intervals(S, jnp.asarray(starts),
                                           jnp.asarray(ends))),
    )


@pytest.mark.parametrize("lut_word,word_size", [(11, 28), (8, 11),
                                                (12, 28)])
def test_mini_extend_matches_jax(packed_problem, lut_word, word_size):
    db, q, rng, plants = packed_problem
    n = 512
    s_off = rng.integers(0, db.padded_length - 1, n)
    q_off = rng.integers(0, len(q) - 1, n)
    # a quarter of the seeds inside planted stretches
    for i in range(n // 4):
        qo, so = plants[i % len(plants)]
        d = int(rng.integers(0, 50))
        q_off[i], s_off[i] = qo + d, so + d
    q_off, s_off = q_off.astype(np.int32), s_off.astype(np.int32)
    starts = np.asarray(db.starts)
    ends = starts + np.asarray(db.lengths)
    oid = np.clip(np.searchsorted(starts, s_off, side="right") - 1, 0,
                  len(starts) - 1)
    lo, hi = starts[oid].astype(np.int32), ends[oid].astype(np.int32)
    sub2 = db.unpacked().astype(np.int8)
    valid = db.valid_mask()
    kw = dict(lut_word=lut_word, word_size=word_size)
    want_b = jx.mini_extend(
        jnp.asarray(q), jnp.asarray(sub2), jnp.asarray(valid),
        jnp.asarray(q_off), jnp.asarray(s_off),
        jnp.asarray(np.ones(n, bool)), **kw,
    )
    want_p = jx.mini_extend_packed(
        jx.pack_query_nibbles(jnp.asarray(q)),
        jx.pack_subject_words(jnp.asarray(db.packed)),
        jnp.asarray(q_off), jnp.asarray(s_off),
        jnp.asarray(np.ones(n, bool)), jnp.asarray(lo), jnp.asarray(hi),
        **kw,
    )
    got_b = pt.mini_extend(_t(q), _t(sub2), _t(valid),
                           _t(q_off.astype(np.int64)),
                           _t(s_off.astype(np.int64)), **kw)
    got_p = pt.mini_extend_packed(
        pt.pack_query_nibbles(_t(q)), pt.pack_subject_words(_t(db.packed)),
        _t(q_off.astype(np.int64)), _t(s_off.astype(np.int64)),
        _t(lo.astype(np.int64)), _t(hi.astype(np.int64)), **kw,
    )
    for got, want in ((got_b, want_b), (got_p, want_p), (got_p, want_b)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got_p[2].sum()) < n


def _setup(rng, query_seqs, subject_seqs, word_size, lut_word):
    qb = build_query_block(
        [FastaRecord(f"q{i}", "", s) for i, s in enumerate(query_seqs)],
        strand="both",
    )
    db = SequenceDB.from_records(
        [FastaRecord(f"s{i}", "", s) for i, s in enumerate(subject_seqs)]
    )
    locs = unmasked_locations(qb.buffer, qb.context_offsets())
    lut = build_lookup_table(qb.buffer, locs, word_size, lut_word)
    return qb, db, lut


@pytest.mark.parametrize("lut_word", [6, 5])    # PV path / dense path
def test_scan_block_matches_jax(lut_word):
    """tests/test_seeding.py TestScanPVPath shapes."""
    rng = np.random.default_rng(1)
    q = _rand_seq(rng, 3000)
    s = (_rand_seq(rng, 1500) + q[100:400] + _rand_seq(rng, 800)
         + q[2000:2300] + _rand_seq(rng, 1000))
    _qb, db, lut = _setup(rng, [q], [s], 12, lut_word)
    sub2 = db.unpacked().astype(np.int8)
    valid = db.valid_mask()
    n_scan = (len(sub2) - lut.lut_word_size) // lut.scan_step + 1
    jq, js, jv, dropped, _nh = jx.scan_block(
        jnp.asarray(sub2), jnp.asarray(valid),
        jnp.asarray(lut.counts_offsets), jnp.asarray(lut.positions),
        scan_step=lut.scan_step, lut_word=lut.lut_word_size,
        word_size=lut.word_size, cmax=64, n_scan=n_scan, hit_cap=4096,
        pos_base_static=0,
    )
    assert int(dropped) == 0
    keep = np.asarray(jv)
    got_q, got_s = pt.scan_block(
        _t(sub2), _t(valid), _t(lut.counts_offsets), _t(lut.positions),
        scan_step=lut.scan_step, lut_word=lut.lut_word_size, n_scan=n_scan,
    )
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(jq)[keep])
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(js)[keep])
    assert len(got_q) > 100


def test_seeding_scan_mini_matches_jax():
    """tests/test_seeding.py test_scan_mini_packed_path_equivalent: two
    reads against a 3-subject db, packed mini-extension, survivors
    compacted to out_cap."""
    rng = np.random.default_rng(3)
    recs = [FastaRecord(f"s{i}", "", _rand_seq(rng, int(rng.integers(
        300, 2000)))) for i in range(3)]
    db = SequenceDB.from_records(recs, title="t")
    genome = "".join("ACGT"[c] for c in db.unpacked()[:2000])
    reads = [FastaRecord("r0", "", genome[100:400]),
             FastaRecord("r1", "", genome[900:1200])]
    qb = build_query_block(reads, "both")
    co = qb.context_offsets()
    locs = unmasked_locations(qb.buffer, co)
    lut = build_lookup_table(qb.buffer, locs, 28, 11)
    qbuf = np.full(32768, 15, np.uint8)
    qbuf[: len(qb.buffer)] = qb.buffer
    n_ctx = len(qb.contexts)
    ctx_off = np.full(65, np.iinfo(np.int32).max, np.int32)
    ctx_off[: len(co)] = co
    xd = np.full(64, 22, np.int32)
    xd[:n_ctx] = [16, 22, 30, 40]
    n_scan = (db.padded_length - 11) // lut.scan_step + 1
    starts = np.asarray(db.starts)
    ends = starts + np.asarray(db.lengths)
    sub2 = db.unpacked().astype(np.int8)
    want = jx.seeding_scan_mini(
        jnp.asarray(sub2), jnp.asarray(db.valid_mask()),
        jnp.asarray(lut.counts_offsets), jnp.asarray(lut.positions),
        jnp.asarray(qbuf), jnp.asarray(ctx_off), jnp.asarray(xd),
        jnp.asarray(starts), jnp.asarray(ends),
        query_nib=jx.pack_query_nibbles(jnp.asarray(qbuf)),
        subject_w=jx.pack_subject_words(jnp.asarray(db.packed)),
        scan_step=lut.scan_step, lut_word=lut.lut_word_size, word_size=28,
        cmax=8, n_scan=n_scan, hit_cap=4096, seed_cap=4096, out_cap=2048,
        pos_base_static=0,
    )
    (wq, ws, wok, wctx, wxd, wml, wmr, n_ovf, n_raw, _nh, _ns) = (
        np.asarray(a) for a in want
    )
    assert int(n_ovf) == 0
    q_t = _t(qbuf)
    got = pt.seeding_scan_mini(
        _t(sub2), _t(db.valid_mask()), _t(lut.counts_offsets),
        _t(lut.positions), pt.pack_query_nibbles(q_t),
        pt.pack_subject_words(_t(db.packed)), _t(co.astype(np.int64)),
        _t(xd[:n_ctx]), _t(starts), _t(ends), query_len=len(qbuf),
        scan_step=lut.scan_step, lut_word=lut.lut_word_size, word_size=28,
        n_scan=n_scan,
    )
    gq, gs, gctx, gxd, gml, gmr, g_raw = got
    assert g_raw == int(n_raw)
    for g, w in ((gq, wq), (gs, ws), (gctx, wctx), (gxd, wxd), (gml, wml),
                 (gmr, wmr)):
        np.testing.assert_array_equal(g.numpy(), w[wok])
    # both reads are plus-strand copies: contexts 0 and 2 seed
    assert len(gq) >= 4 and set(gctx.tolist()) == {0, 2}
