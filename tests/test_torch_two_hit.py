"""Two-hit seeding in the port on the CPU: the plain versions of the
double-word probe RR, the two-hit replay R and the gate G with a right run,
against the JAX package's host twins (``compute_right_runs``,
``two_hit_diag_filter``, native and Python) and its ``right_run_packed``;
the port's host oracle ``_finish_init_hits`` with a window against the JAX
package's; and ``run_seeding``'s device finish (plain versions) against the
oracle on two-hit batches. Inputs come from seeded numpy generators (the
random sets of ``tools/replay_sets.py`` at a small size); every comparison
is exact."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gblastn_tpu.engine import seeding as jseed
from gblastn_tpu.engine.approx import compute_approx_info
from gblastn_tpu.ops.seeding import pack_query_nibbles as jax_pack_nib
from gblastn_tpu.ops.seeding import pack_subject_words as jax_pack_words
from gblastn_tpu.ops.seeding import right_run_packed
from gblastn_tpu_torch import FastaRecord, SequenceDB
from gblastn_tpu_torch.engine import seeding as tseed
from gblastn_tpu_torch.engine.search import setup_batch
from gblastn_tpu_torch.ops import replay as rp
from gblastn_tpu_torch.ops.seeding import pack_query_nibbles, pack_subject_words
from gblastn_tpu_torch.ops.ungapped import ungapped_extend_window
from gblastn_tpu_torch.params.derived import nucl_score_table_packed
from gblastn_tpu_torch.params.options import (
    blastn_options,
    dc_megablast_options,
    megablast_options,
)
from gblastn_tpu_torch.tools import replay_sets
from tests.test_torch_replay import _gate_fixture

# the plain versions run many small ops: on the CPU one thread beats a pool
torch.set_num_threads(1)

WINDOW = 40


def _t(a, dt=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


@pytest.mark.parametrize("word", [11, 28])
def test_right_run_matches_host_and_jax(word):
    """RR's plain version equals compute_right_runs (the JAX package's and
    the port's copy) and JAX's right_run_packed, with runs of every length
    0..word, N/R/Y and sentinels, and subject and query ends in the run."""
    db, query, q, s, oid = replay_sets.run_arrays(word, n=6000)
    starts = np.asarray(db.starts, np.int64)
    ends = starts + np.asarray(db.lengths, np.int64)
    sub2 = db.unpacked()
    valid = db.valid_mask()
    got = rp.right_run(
        _nibbles(query), _words(db), _t(ends, torch.int64), _t(q), _t(s),
        _t(oid), word_size=word).numpy()
    want = jseed.compute_right_runs(query, sub2, valid, q, s, word)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tseed.compute_right_runs(query, sub2, valid, q, s, word), want)
    packed = right_run_packed(
        jax_pack_nib(jnp.asarray(query)),
        jax_pack_words(jnp.asarray(db.packed_padded())),
        jnp.asarray(q.astype(np.int32)), jnp.asarray(s.astype(np.int32)),
        jnp.ones(len(q), bool), jnp.asarray(ends[oid].astype(np.int32)),
        word_size=word)
    np.testing.assert_array_equal(got, np.asarray(packed))
    # every run length occurs, and the ends cut some runs short
    assert set(np.unique(got)) == set(range(word + 1))


def _nibbles(query):
    return pack_query_nibbles(_t(query, torch.uint8))


def _words(db):
    return pack_subject_words(_t(db.packed_padded(), torch.uint8))


def test_right_run_reads_nothing_for_a_bad_subject_index():
    """A seed whose subject index is out of range has a run of 0."""
    db, query, q, s, oid = replay_sets.run_arrays(11, n=64)
    ends = np.asarray(db.starts, np.int64) + np.asarray(db.lengths)
    oid = oid.copy()
    oid[::2] = [-1, 99] * (len(oid) // 4)
    got = rp.right_run(_nibbles(query), _words(db),
                       _t(ends, torch.int64), _t(q), _t(s), _t(oid),
                       word_size=11).numpy()
    assert (got[::2] == 0).all()


def _two_hit(q, s, oid, end, score, cutoff, run, word, mask, window):
    """R's plain version on numpy seeds: the saved mask."""
    qt, st, ot = _t(q), _t(s), _t(oid)
    key, order, shift = rp.replay_keys(qt, st, ot, mask,
                                       **replay_sets.key_bounds(q, s, oid))
    return rp.diag_replay(key, order, st, _t(end), _t(score), _t(cutoff),
                          word_size=word, window=window, right_run=_t(run),
                          key_shift=shift).numpy().astype(bool)


@pytest.mark.parametrize("word,mask,dense", [
    (11, 0, 300),
    (28, tseed.diag_table_mask(4000, WINDOW), 0),
    (11, 127, 0),
])
def test_two_hit_replay_matches_host_twins(word, mask, dense):
    """Two-hit R's plain version equals two_hit_diag_filter (the JAX
    package's and the port's, native and Python) on the random set: chains
    with second hits inside and outside the window, double words, pairs at
    s + word == last_hit + window and one base past it, virgin diagonals,
    identical seeds, a dense chain, the aliasing mask with the window in
    its length; and with window 0 it equals the one-hit replay, runs
    ignored."""
    q, s, oid, end, score, cutoff, run = replay_sets.two_hit_arrays(
        4000, word, WINDOW, mask, dense, seed=55)
    got = _two_hit(q, s, oid, end, score, cutoff, run, word, mask, WINDOW)
    a32 = [a.astype(np.int32) for a in (q, s, oid, end, score, cutoff, run)]
    z = np.zeros(len(q), np.int32)
    for mod in (jseed, tseed):
        for native in (True, False):
            want = mod.two_hit_diag_filter(
                *a32[:3], word, WINDOW, a32[3], z, a32[4], a32[5], a32[6],
                use_native=native, diag_mask=mask)
            np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    one = _two_hit(q, s, oid, end, score, cutoff, run, word, mask, 0)
    want1 = tseed.one_hit_diag_filter(*a32[:3], word, a32[3], z, a32[4],
                                      a32[5], diag_mask=mask)
    np.testing.assert_array_equal(one, want1)
    assert not np.array_equal(one, got)


def test_two_hit_boundary_pairs():
    """On one diagonal, word 11, window 40, every score passing: a first
    hit with run 3 fails as single (last_hit = s + 14); a seed with s + 11
    == last_hit + 40 is a second hit and is saved; on another diagonal one
    base further it is a first hit again and is not; a double word (run
    11) on a virgin diagonal is saved alone; a seed before last_hit is
    skipped."""
    W = 11
    rows = [  # (q, s, run)
        (10, 110, 3), (53, 153, 0),     # 153 + 11 == 124 + 40: saved
        (10, 210, 3), (54, 254, 0),     # one past: a first hit, not ready
        (10, 310, W),                   # a virgin double word: saved
        (11, 211, 0),                   # s < last_hit = 224: skipped
    ]
    q = np.array([r[0] for r in rows])
    s = np.array([r[1] for r in rows])
    run = np.array([r[2] for r in rows])
    n = len(rows)
    oid = np.zeros(n, np.int64)
    end = s + 60
    score = np.full(n, 30)
    cutoff = np.full(n, 22)
    got = _two_hit(q, s, oid, end, score, cutoff, run, W, 0, WINDOW)
    want = jseed.two_hit_diag_filter(
        *(a.astype(np.int32) for a in (q, s, oid)), W, WINDOW,
        end.astype(np.int32), np.zeros(n, np.int32),
        score.astype(np.int32), cutoff.astype(np.int32),
        run.astype(np.int32), use_native=False)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [False, True, False, False, True, False]


@pytest.mark.parametrize("use_native", [True, False])
def test_gate_demotes_with_the_run(use_native):
    """G's plain version with right runs writes the demoted lengths that
    the JAX package's host finish writes from its approximate pass
    (``compute_approx_info``), max(s + word + run - a_s, a_r - a_q + 1),
    and without runs the one-hit lengths."""
    db, query, sd, tabs, concat_end = _gate_fixture(4711)
    sd["run"] = np.random.default_rng(4712).integers(0, 12, len(sd["q"]))
    starts = np.asarray(db.starts, np.int64)
    ends = starts + np.asarray(db.lengths, np.int64)
    table = nucl_score_table_packed(1, -2)
    need = sd["ug_score"] >= tabs[0][sd["ctx"]]
    dem, a_sc, a_q, a_s, a_r = compute_approx_info(
        query, concat_end, db.packed, starts[sd["oid"]], ends[sd["oid"]],
        sd["q"], sd["s"], sd["ctx"].astype(np.int32), tabs[2],
        tabs[1].astype(np.int64), table, need, use_native=use_native)
    assert dem.sum() > 20
    args = (rp.query_bytes(_t(query, torch.uint8)),
            _t(db.packed_padded(), torch.uint8), _t(table), _t(tabs),
            _t(starts, torch.int64), _t(ends, torch.int64),
            *(_t(sd[k]) for k in ("q", "s", "ctx", "oid", "ug_q", "ug_s",
                                  "ug_len", "ug_score")))
    for run in (sd["run"], None):
        ext = run if run is not None else 0
        got = rp.approx_gate(*args, word_size=11, concat_end=concat_end,
                             right_run=None if run is None else _t(run))
        want_len = sd["ug_len"].copy()
        want_len[dem] = np.maximum(sd["s"] + 11 + ext - a_s,
                                   a_r - a_q + 1)[dem]
        np.testing.assert_array_equal(got[2].numpy(), want_len)
        np.testing.assert_array_equal(got[1].numpy()[dem], a_s[dem])


def test_host_oracle_matches_jax_with_demotions():
    """On the gate's random rows (planted matches, N/R, sentinels, two
    contexts), with right runs and window 40, the port's host oracle
    keeps the JAX package's InitHits field by field, demoted lengths
    counted from the run included."""
    db, query, sd, tabs, concat_end = _gate_fixture(4713)
    n = len(sd["q"])
    run = np.random.default_rng(4714).integers(0, 12, n).astype(np.int32)
    starts = np.asarray(db.starts, np.int64)
    ctx = dict(query=query, concat_end=concat_end, packed=db.packed,
               subject_ends=starts + np.asarray(db.lengths, np.int64),
               x_dropoffs=tabs[2], reduced=tabs[1].astype(np.int64),
               table=nucl_score_table_packed(1, -2))
    rows = [sd[k] for k in ("q", "s", "ctx", "ug_q", "ug_s", "ug_len",
                            "ug_score")]
    kw = dict(concat_qlen=concat_end - 1, approx_ctx=ctx,
              window_size=WINDOW, right_run=run)
    got = tseed._finish_init_hits(*rows, tabs[0], db.starts, 11, **kw)
    want = jseed._finish_init_hits(*rows, tabs[0], db.starts, 11, **kw)
    need = sd["ug_score"] >= tabs[0][sd["ctx"]]
    dem = compute_approx_info(
        query, concat_end, db.packed, starts[sd["oid"]],
        ctx["subject_ends"][sd["oid"]], sd["q"], sd["s"],
        sd["ctx"].astype(np.int32), tabs[2], ctx["reduced"], ctx["table"],
        need)[0]
    assert dem.sum() > 20 and len(got) > 20
    for name in ("q_off", "s_off", "q_start", "s_start", "length", "score",
                 "context", "oid"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def _batch(kind):
    """A small two-hit batch on the CPU: six reads of 600 bases (3%
    substitutions, one reverse-complemented, one with an N) from two
    subjects, as megablast word 28 (LUT width below 28: RR probes),
    blastn word 11 (LUT width 8 under 12,000 query bases: RR probes),
    or dc-megablast with two templates (no RR)."""
    rng = np.random.default_rng({"mb": 17, "bn": 18, "dc": 19}[kind])
    g = ["".join("ACGT"[c] for c in rng.integers(0, 4, L))
         for L in (30000, 9000)]
    db = SequenceDB.from_records(
        [FastaRecord(f"g{i}", "", x) for i, x in enumerate(g)], title="t")
    reads = []
    for k in range(6):
        src = g[k % 2]
        st = int(rng.integers(0, len(src) - 700))
        r = list(src[st: st + 600])
        rate = 0.12 if kind == "dc" else 0.03
        for p in np.flatnonzero(rng.random(600) < rate):
            r[p] = "ACGT"[("ACGT".index(r[p]) + 1) % 4]
        if k == 2:
            r[300] = "N"
        seq = "".join(r)
        if k == 3:
            seq = seq[::-1].translate(str.maketrans("ACGTN", "TGCAN"))
        reads.append(FastaRecord(f"r{k}", "", seq))
    opts = {"mb": megablast_options(evalue=1e-5, window_size=WINDOW),
            "bn": blastn_options(evalue=1e-5, window_size=WINDOW),
            "dc": dc_megablast_options(
                evalue=1e-5, template_type="coding_and_optimal")}[kind]
    return setup_batch(reads, db, opts, "cpu")


def _oracle_inputs(batch):
    """K1's rows of a batch, its right runs (compute_right_runs on the
    host, zeros where the path does not probe) and the oracle keywords."""
    kw, okw = batch.seed_kw, batch.oracle_kw
    ctx, k1_args, _n = tseed.ungapped_inputs(batch.seed_dev, **kw)
    uq, us, ulen, usc, _f = ungapped_extend_window(*k1_args)
    rows = [t.numpy() for t in (k1_args[3], k1_args[4], ctx.to(torch.int32),
                                uq, us, ulen, usc)]
    db_sub = batch.seed_dev.resident
    if tseed.probes_double_words(batch.seed_dev, kw):
        run = tseed.compute_right_runs(
            okw["approx_ctx"]["query"], db_sub.subject2.numpy(),
            db_sub.valid.numpy(), rows[0], rows[1], kw["word_size"])
    else:
        run = np.zeros(len(rows[0]), np.int32)
    n_ctx = len(kw["x_dropoffs"])
    common = dict(concat_qlen=int(kw["context_offsets"][n_ctx]) - 2,
                  approx_ctx=okw["approx_ctx"],
                  window_size=batch.seed_dev.window, right_run=run)
    return rows, okw, common


@pytest.mark.parametrize("kind", ["mb", "bn", "dc"])
def test_host_oracle_matches_jax_with_the_window(kind):
    """The port's _finish_init_hits with window 40 (and right runs) gives
    the JAX package's InitHits field by field on a two-hit batch's K1
    rows."""
    batch = _batch(kind)
    rows, okw, common = _oracle_inputs(batch)
    if kind != "dc":
        assert common["right_run"].max() > 0
    got = tseed._finish_init_hits(
        *rows, okw["word_cutoffs"], okw["subject_starts"],
        batch.seed_kw["word_size"], **common)
    want = jseed._finish_init_hits(
        *rows, okw["word_cutoffs"], okw["subject_starts"],
        batch.seed_kw["word_size"], **common)
    assert len(got) > 3
    for name in ("q_off", "s_off", "q_start", "s_start", "length", "score",
                 "context", "oid"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


@pytest.mark.parametrize("kind", ["mb", "bn", "dc"])
def test_run_seeding_matches_the_two_hit_oracle(kind):
    """run_seeding's device finish (RR where the path probes, G, two-hit
    R; the plain versions on the CPU) gives InitHits equal field by field
    to the host oracle with the window, and RR's plain version equals
    compute_right_runs on the path's own seeds."""
    batch = _batch(kind)
    rows, okw, common = _oracle_inputs(batch)
    got = tseed.run_seeding(batch.seed_dev, **batch.seed_kw)
    want = tseed._finish_init_hits(
        *rows, okw["word_cutoffs"], okw["subject_starts"],
        batch.seed_kw["word_size"], **common)
    assert len(got) > 3
    for name in ("q_off", "s_off", "q_start", "s_start", "length", "score",
                 "context", "oid"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    case = replay_sets.batch_run_case(batch)
    assert (case is None) == (kind == "dc")
    if case is not None:
        args, kw = case
        np.testing.assert_array_equal(rp.right_run(*args, **kw).numpy(),
                                      common["right_run"])
