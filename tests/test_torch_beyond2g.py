"""Subject coordinates past 2^31 on the CPU, without a 2^31-base subject:
the port's host oracle ``_finish_init_hits`` (with its per-(oid,
diagonal-class) rebase) against the JAX package's on
tests/test_dev_replay.py::TestBeyond2G's seeds, one-hit and two-hit,
its two OverflowErrors included; R's order (``replay_keys``) and R's
plain version on int64 subject-local coordinates against the host finish,
one subject and many; and the scan by chunks against the whole scan.
Inputs come from seeded numpy generators; every comparison is exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu.engine.seeding import _finish_init_hits as jax_finish
from gblastn_tpu_torch.engine.seeding import (
    NARROW_SUBJECT,
    _finish_init_hits,
    diag_table_mask,
)
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.ops import replay as rp
from gblastn_tpu_torch.ops.seeding import scan_block
from tests.test_torch_search import _rand

torch.set_num_threads(1)

FIELDS = ("q_off", "s_off", "q_start", "s_start", "length", "score",
          "context", "oid")


def _seeds(rng, n=400, base=(1 << 31) + 12345, classes=8):
    """TestBeyond2G's seeds: clusters on shared diagonals around and past
    ``base``, their ungapped extensions, scores and runs."""
    qs = rng.integers(100, 30000, n).astype(np.int64)
    ss = qs + rng.integers(0, classes, n) * 1000 + base
    ug_q = qs - rng.integers(0, 50, n)
    return dict(q=qs, s=ss, ctx=np.zeros(n, np.int32), ug_q=ug_q,
                ug_s=ss - (qs - ug_q),
                ug_len=rng.integers(28, 400, n).astype(np.int64),
                ug_score=rng.integers(0, 60, n).astype(np.int64),
                run=rng.integers(0, 29, n).astype(np.int32))


def _finish_both(sd, starts, window=0, scan_range=0, qlen=60000):
    args = (sd["q"], sd["s"], sd["ctx"], sd["ug_q"], sd["ug_s"],
            sd["ug_len"], sd["ug_score"], np.array([20], np.int32),
            np.asarray(starts, np.int64), 28)
    run = sd["run"] if window else None
    got = _finish_init_hits(*args, concat_qlen=qlen, window_size=window,
                            right_run=run, scan_range=scan_range)
    want = jax_finish(*args, window_size=window, right_run=run,
                      scan_range=scan_range, concat_qlen=qlen)
    return got, want


@pytest.mark.parametrize("window,qlen", [(0, 60000), (40, 60000),
                                         (0, 6000), (40, 6000)])
@pytest.mark.parametrize("starts", [[0], [0, 700_000_000, 2_000_000_000]])
def test_finish_init_hits_beyond_2g(window, qlen, starts):
    """The host finish of seeds past 2^31 equals the JAX package's field
    by field, one-hit and two-hit, exact and aliasing diagonals, on one
    subject and on the last of three; every saved seed lies past 2^31."""
    sd = _seeds(np.random.default_rng(11 + window + len(starts)))
    got, want = _finish_both(sd, starts, window, qlen=qlen)
    assert len(got) > 0 and int(np.min(got.s_off)) > (1 << 31)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


def test_finish_init_hits_overflow_cases():
    """Past 2^31 the rebase refuses, as the JAX package's does, a
    two-hit search with -off_diagonal_range and a diagonal class that
    spans 2^31 bases."""
    sd = _seeds(np.random.default_rng(3))
    for fn in (_finish_init_hits, jax_finish):
        with pytest.raises(OverflowError, match="off_diagonal_range"):
            fn(sd["q"], sd["s"], sd["ctx"], sd["ug_q"], sd["ug_s"],
               sd["ug_len"], sd["ug_score"], np.array([20], np.int32),
               np.zeros(1, np.int64), 28, window_size=40,
               right_run=sd["run"], scan_range=2)
    # two seeds of one diagonal class, 2^31 + 2^21 bases apart
    far = (1 << 31) + (1 << 21)
    sd["s"][0] = sd["q"][0] + 5
    sd["q"][1], sd["s"][1] = sd["q"][0] + far, sd["s"][0] + far
    for fn in (_finish_init_hits, jax_finish):
        with pytest.raises(OverflowError, match="diagonal class"):
            fn(sd["q"], sd["s"], sd["ctx"], sd["ug_q"], sd["ug_s"],
               sd["ug_len"], sd["ug_score"], np.array([20], np.int32),
               np.zeros(1, np.int64), 28)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("lengths,mask", [
    ([3_200_000_000], 0),                        # one subject past 2^32
    ([3_200_000_000], 4095),                     # an aliasing mask
    ([1_000_000_000, 150_000_000, 2_400_000_000], 0),
    ([1_000_000_000, 150_000_000, 2_400_000_000], 255)])
def test_replay_keys_and_plain_r_beyond_2g(lengths, mask, window):
    """R's order and R's plain version on int64 subject-local
    coordinates save the seeds the host finish saves (the JAX package's
    python replay over global int64 coordinates): the keys take their
    widths from bounds past 32 bits (two sorts where the packed key
    passes 63 bits), and the seeds lie past 2^31 in a subject past
    2^31."""
    rng = np.random.default_rng(sum(lengths) % 1000 + mask + window)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1] + 128])
    n = 3000
    oid = rng.integers(0, len(lengths), n)
    oid[: n // 2] = len(lengths) - 1
    q = rng.integers(0, 20000, n)
    # clusters of seeds on shared diagonals near the subject's end
    s_loc = np.minimum(
        np.asarray(lengths)[oid] - 2000 - rng.integers(0, 6, n) * 1000 + q
        - 20000, np.asarray(lengths)[oid] - 500)
    ug_back = rng.integers(0, 40, n)
    ug_len = rng.integers(28, 300, n)
    end_loc = s_loc - ug_back + ug_len
    score = rng.integers(0, 60, n).astype(np.int32)
    cut = np.full(n, 22, np.int32)
    run = rng.integers(0, 29, n).astype(np.int32)
    assert s_loc.max() >= NARROW_SUBJECT
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in dict(
        q=q.astype(np.int32), s=s_loc.astype(np.int64),
        oid=oid.astype(np.int32), end=end_loc.astype(np.int64),
        score=score, cut=cut, run=run).items()}
    bounds = dict(n_sub=len(lengths), s_len=max(lengths), q_len=20000)
    layout = rp.key_layout(**bounds, diag_mask=mask)
    key, order, shift = rp.replay_keys(t["q"], t["s"], t["oid"], mask,
                                       **bounds)
    assert (shift == 0) == (layout is None)
    saved = rp.diag_replay(key, order, t["s"], t["end"], t["score"],
                           t["cut"], word_size=28, window=window,
                           right_run=t["run"], key_shift=shift).numpy()
    s_glob = s_loc + starts[oid]
    from gblastn_tpu.engine.seeding import (
        one_hit_diag_filter,
        two_hit_diag_filter,
    )
    common = (q, s_glob, oid.astype(np.int32), 28)
    ext = (s_glob - ug_back, ug_len, score, cut)
    if window:
        want = two_hit_diag_filter(*common, window, *ext, run,
                                   use_native=False, diag_mask=mask)
    else:
        want = one_hit_diag_filter(*common, *ext, use_native=False,
                                   diag_mask=mask)
    assert 0 < int(want.sum()) < n
    np.testing.assert_array_equal(saved.astype(bool), want)


@pytest.mark.parametrize("template", [None, (11, 16, "coding")])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_scan_equals_the_whole_scan(template, masked):
    """scan_block by chunks of 97 and 1,000 scan positions gives the
    whole scan's seeds in its order, with and without mask intervals (a
    masked word is not seeded) and with a discontiguous template."""
    from gblastn_tpu_torch.engine.resident import resident_from_reference
    from gblastn_tpu_torch.lut.builder import (
        build_disc_lookup_table,
        build_lookup_table,
    )

    rng = np.random.default_rng(17)
    g1, g2 = _rand(rng, 9000), _rand(rng, 6000)
    db = SequenceDB.from_records([FastaRecord("a", "", g1),
                                  FastaRecord("b", "", g2)])
    q = _rand(rng, 800) + g1[1000:1900] + g2[300:1200] + g1[7000:7600]
    buf = np.array([15] + ["ACGT".index(c) for c in q] + [15], np.uint8)
    locs = [(1, len(buf) - 2)]
    if template:
        lut = build_disc_lookup_table(buf, locs, *template)
        step = 1
    else:
        lut = build_lookup_table(buf, locs, 28, 12)
        step = lut.scan_step
    res = resident_from_reference(db, torch.device("cpu"))
    ms = me = None
    if masked:
        b = int(db.starts[1])
        ivs = torch.tensor([[1200, 1500], [1700, 1800], [b + 500, b + 900]])
        ms, me = ivs[:, 0].contiguous(), ivs[:, 1].contiguous()
    span = lut.disc_offsets[-1] + 1 if template else lut.lut_word_size
    kw = dict(scan_step=step, lut_word=lut.lut_word_size,
              n_scan=(res.length - span) // step + 1,
              disc_offsets=lut.disc_offsets, mask_starts=ms, mask_ends=me)
    args = (res.subject2, res.valid, torch.from_numpy(lut.counts_offsets),
            torch.from_numpy(lut.positions))
    whole = scan_block(*args, **kw)
    plain = scan_block(*args, **dict(kw, mask_starts=None, mask_ends=None))
    assert len(whole[0]) > 50
    for chunk in (97, 1000):
        got = scan_block(*args, **kw, chunk=chunk)
        for a, b in zip(got, whole):
            assert torch.equal(a, b)
    if masked:
        s = plain[1]
        inside = torch.zeros_like(s, dtype=torch.bool)
        for a, b in ivs.tolist():
            inside |= (s < b) & (s + span > a)
        assert int(inside.sum()) > 0
        keep = ~inside
        assert torch.equal(whole[0], plain[0][keep])
        assert torch.equal(whole[1], plain[1][keep])


def test_giant_workload_matches_bench(monkeypatch):
    """workloads.giant_workload gives bench.py's bench_config4 database
    and reads (the same draws from SEED + 4), here at 400 kb and 8
    reads."""
    import bench
    import gblastn_tpu.engine.search as jes
    from gblastn_tpu_torch.tools import workloads

    seen = []

    class _Empty:
        queries = []

    def record(reads, db, options):
        seen.append((db, [(r.seq_id, r.sequence) for r in reads]))
        return _Empty()

    monkeypatch.setattr(jes, "search", record)
    monkeypatch.setenv("GBLASTN_BENCH_GIANT_BASES", "400000")
    monkeypatch.setenv("GBLASTN_BENCH_GIANT_QUERIES", "8")
    bench.bench_config4()
    db, pairs, starts = workloads.giant_workload(400_000, 8)
    jdb, reads = seen[-1]
    assert reads == pairs and len(pairs) == 8
    np.testing.assert_array_equal(db.packed, jdb.packed)
    assert (db.lengths.tolist(), db.ids) == (jdb.lengths.tolist(), jdb.ids)
    assert workloads.GIANT_BASES == 3_200_000_000


@pytest.mark.parametrize("recipe", ["giant", "chroms"])
def test_genome_scale_recipes_at_a_small_size(recipe):
    """The giant and chroms recipes, cut to a small size (giant 600 kb,
    chroms at 1/20,000 of GRCh38's lengths), searched by the port on the
    CPU with megablast -evalue 1e-5 -max_target_seqs 10: every read's
    best hit lies within 64 bases of its plant; chroms' far reads sit on
    the chromosomes from chr14 on, and its pads are zero codes."""
    from gblastn_tpu_torch.params.options import megablast_options
    from gblastn_tpu_torch.tools import workloads

    if recipe == "giant":
        db, pairs, plants = workloads.giant_workload(600_000, 6)
    else:
        small = tuple((c, n // 20_000) for c, n in workloads.GRCH38_CHROMS)
        db, pairs, plants, owner = workloads.chroms_workload(
            small, num=10, far=4)
        assert min(owner[:4]) >= 13 and max(owner[4:]) < 13
        valid = db.valid_mask()
        assert (db.unpacked()[~valid] == 0).all()
        ref = SequenceDB.from_records(
            [FastaRecord(c, "", "".join(
                "ACGT"[x] for x in db.get_sequence_2na(k)))
             for k, (c, _n) in enumerate(small)])
        np.testing.assert_array_equal(ref.packed, db.packed)
    from gblastn_tpu_torch.engine.search import search

    res = search([FastaRecord(n, "", s) for n, s in pairs], db,
                 megablast_options(evalue=1e-5, max_target_seqs=10),
                 device="cpu")
    for q in res.queries:
        best = max((h for lst in q.hsplists for h in lst.hsps),
                   key=lambda h: h.score)
        lst = next(l for l in q.hsplists if best in l.hsps)
        lo = int(db.starts[lst.oid]) + min(best.s_off, best.s_end)
        assert abs(lo - plants[q.query_index]) <= 64
    assert len(res.queries) == len(pairs)


def test_chunked_mini_extension_equals_the_whole(monkeypatch):
    """The mini-extension by chunks of 13 raw seeds gives K1's inputs of
    the whole pass, in its order (ops/seeding.py::MINI_CHUNK)."""
    import gblastn_tpu_torch.ops.seeding as ops_seeding
    from gblastn_tpu_torch.engine.search import setup_batch
    from gblastn_tpu_torch.engine.seeding import ungapped_inputs
    from gblastn_tpu_torch.params.options import megablast_options

    rng = np.random.default_rng(23)
    g = _rand(rng, 12000)
    db = SequenceDB.from_records([FastaRecord("a", "", g[:7000]),
                                  FastaRecord("b", "", g[7000:])])
    reads = [FastaRecord(f"r{i}", "", g[st: st + 400])
             for i, st in enumerate((100, 2500, 6800, 9000))]
    batch = setup_batch(reads, db, megablast_options(), "cpu")
    ctx, args, n_raw = ungapped_inputs(batch.seed_dev, **batch.seed_kw)
    monkeypatch.setattr(ops_seeding, "MINI_CHUNK", 13)
    ctx2, args2, n_raw2 = ungapped_inputs(batch.seed_dev, **batch.seed_kw)
    assert n_raw == n_raw2 > 13 * 3 and args[3].numel() > 13
    assert torch.equal(ctx, ctx2)
    for a, b in zip(args[3:], args2[3:]):
        assert torch.equal(a, b)


def test_resident_build_by_chunks_equals_the_jax_forms(monkeypatch):
    """The resident form built BUILD_CHUNK at a time (here 40, so that
    subjects, pads and chunk edges fall at every phase) equals the JAX
    package's subject arrays: codes, validity mask and 16-base words."""
    from gblastn_tpu.ops.seeding import subject_arrays_from_packed

    import gblastn_tpu_torch.ops.seeding as ops_seeding
    from gblastn_tpu_torch.engine.resident import resident_from_reference

    rng = np.random.default_rng(41)
    db = SequenceDB.from_records([FastaRecord(f"s{k}", "", _rand(rng, n))
                                  for k, n in enumerate((1000, 129, 700))])
    monkeypatch.setattr(ops_seeding, "BUILD_CHUNK", 40)
    res = resident_from_reference(db, torch.device("cpu"))
    starts = np.asarray(db.starts)
    sub2, valid, sw = subject_arrays_from_packed(
        db.packed_padded(), starts, starts + np.asarray(db.lengths))
    np.testing.assert_array_equal(res.subject2.numpy(), np.asarray(sub2))
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(res.subject_w.numpy(),
                                  np.asarray(sw).astype(np.int64))
