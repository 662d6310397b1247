"""Two-hit seeding with -off_diagonal_range in the port on the CPU: the
port's ``two_hit_scan_range_filter`` against the JAX package's on random
arrays (ranges 1, 4 and 40, the aliasing diagonal mask, virgin diagonals
at the subject start, double words), the host finish
``_finish_init_hits(scan_range=4)`` against the JAX package's (with the
approximate data, and seeds saved below the cutoff), ``run_seeding``'s
off-diagonal path (plain versions) against the port's host finish, and
``search()`` and the CLI against the JAX package on
tests/test_oracle_parity.py's off-diagonal workloads. Inputs come from
seeded numpy generators; every comparison is exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu.cli.main import main as jax_main
from gblastn_tpu.engine import seeding as jseed
from gblastn_tpu.engine.search import search as jax_search
from gblastn_tpu.io.fasta import FastaRecord as JaxRecord
from gblastn_tpu.io.seqdb import SequenceDB as JaxDB
from gblastn_tpu_torch.cli.main import main as torch_main
from gblastn_tpu_torch.engine import seeding as tseed
from gblastn_tpu_torch.engine.search import search as torch_search
from gblastn_tpu_torch.engine.search import setup_batch
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.ops.replay import right_run
from gblastn_tpu_torch.ops.ungapped import ungapped_extend_window
from gblastn_tpu_torch.params.options import options_for_task
from gblastn_tpu_torch.tools.workloads import (
    below_cutoff_reads,
    offdiag_reads,
)
from tests.test_torch_search import _jax_options, _rows

torch.set_num_threads(1)

FIELDS = ("q_off", "s_off", "q_start", "s_start", "length", "score",
          "context", "oid")


def _random_seeds(rng, n, word, window):
    """n seeds of two subjects clustered on a few diagonals, each
    jittered by a few diagonals (so neighbours interact), a fifth of
    them at the subject start (virgin diagonals with s < window), runs
    of every length with a share of double words, and extensions around
    the seed."""
    oid = rng.integers(0, 2, n)
    base = rng.integers(-300, 3000, 40)[rng.integers(0, 40, n)]
    diag = base + rng.integers(-6, 7, n)
    q = rng.integers(0, 400, n)
    s = np.maximum(diag + q, 0)
    start = rng.random(n) < 0.2
    s[start] = rng.integers(0, window, int(start.sum()))
    q = np.maximum(s - diag, 0)
    runs = np.where(rng.random(n) < 0.2, word,
                    rng.integers(0, word + 1, n))
    us = s - rng.integers(0, 30, n)
    ulen = rng.integers(word, 120, n)
    score = rng.integers(10, 60, n)
    cutoff = np.full(n, 34)
    return [a.astype(np.int32) for a in (q, s, oid, us, ulen, score, cutoff,
                                         runs)]


@pytest.mark.parametrize("scan_range", [1, 4, 40])
@pytest.mark.parametrize("diag_mask", [0, 255])
def test_scan_range_filter_matches_jax(scan_range, diag_mask):
    """The port's replay saves the JAX package's seeds: word 11 and 28,
    window 40, ranges 1, 4 and 40 (40 clips to window - word), exact
    diagonals and the aliasing mask of a small query."""
    for word, seed in ((11, 1), (28, 2)):
        rng = np.random.default_rng(100 * scan_range + diag_mask + seed)
        q, s, oid, us, ulen, score, cutoff, runs = _random_seeds(
            rng, 6000, word, 40)
        args = (q, s, oid, word, 40, scan_range, us, ulen, score, cutoff,
                runs)
        got = tseed.two_hit_scan_range_filter(*args, diag_mask=diag_mask)
        want = jseed.two_hit_scan_range_filter(*args, diag_mask=diag_mask)
        np.testing.assert_array_equal(got, want)
        # some saves come from the probe alone, and some seeds are not
        # saved
        assert (got & (score < cutoff)).any()
        assert 0 < got.sum() < len(got)


def _k1_rows(batch):
    """The host finish's inputs for ``batch`` (port, CPU): K1's seeds
    and outputs (plain version), and the runs of RR where it probes."""
    kw = batch.seed_kw
    ctx, k1_args, _n = tseed.ungapped_inputs(batch.seed_dev, **kw)
    ung = ungapped_extend_window(*k1_args)
    rows = [t.numpy() for t in (k1_args[3], k1_args[4], ctx, *ung[:4])]
    runs = np.zeros(len(rows[0]), np.int32)
    if tseed.probes_double_words(batch.seed_dev, kw):
        res = batch.seed_dev.resident
        oid = torch.searchsorted(res.starts, k1_args[4], right=True) - 1
        runs = right_run(batch.seed_dev.query_nib, res.subject_w, res.ends,
                         k1_args[3], k1_args[4], oid.to(torch.int32),
                         word_size=kw["word_size"]).numpy()
    return rows, runs


def _host_finish(pkg, batch, rows, runs, scan_range, raise_by=0):
    """``pkg``'s host finish on ``rows``; ``raise_by`` lifts every word
    cutoff and reduced cutoff (so the probe's saves fall below the
    cutoff and their approximate walks below the reduced one)."""
    kw, okw = batch.seed_kw, batch.oracle_kw
    n_ctx = len(kw["x_dropoffs"])
    approx = dict(okw["approx_ctx"])
    approx["reduced"] = approx["reduced"] + raise_by
    return pkg._finish_init_hits(
        *rows, okw["word_cutoffs"] + raise_by, okw["subject_starts"],
        kw["word_size"], concat_qlen=int(kw["context_offsets"][n_ctx]) - 2,
        approx_ctx=approx, window_size=batch.seed_dev.window,
        right_run=runs, scan_range=scan_range)


def _equal(got, want):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_finish_init_hits_matches_jax_below_cutoff():
    """``_finish_init_hits(scan_range=4)`` with the approximate data
    equals the JAX package's on the below-cutoff workload: as it is (the
    probe makes each read's seed ready; range 0 saves none), and with
    every cutoff lifted by 30, so that the probe saves seeds below their
    cutoff and the second approximate pass rewrites their rows."""
    genome, reads = below_cutoff_reads()
    db = SequenceDB.from_records([FastaRecord("chr1", "", genome)])
    opts = options_for_task("blastn", evalue=20.0, window_size=40,
                            dust=False, off_diagonal_range=4)
    batch = setup_batch([FastaRecord(*r) for r in reads], db, opts, "cpu")
    rows, runs = _k1_rows(batch)
    got = _host_finish(tseed, batch, rows, runs, 4)
    _equal(got, _host_finish(jseed, batch, rows, runs, 4))
    assert len(got) >= 8
    assert len(_host_finish(tseed, batch, rows, runs, 0)) == 0
    low = _host_finish(tseed, batch, rows, runs, 4, raise_by=30)
    _equal(low, _host_finish(jseed, batch, rows, runs, 4, raise_by=30))
    cutoff = batch.oracle_kw["word_cutoffs"][low.context] + 30
    assert len(low) >= 8 and (low.score < cutoff).all()
    assert (low.score != got.score).any()     # the approximate rows


@pytest.mark.parametrize("task,extra", [
    ("blastn", {}), ("megablast", {}),
    ("dc-megablast", {"template_type": "coding_and_optimal"})])
def test_run_seeding_equals_host_finish(task, extra):
    """The off-diagonal path of ``run_seeding`` (scan, K1, RR where it
    probes and G, then the host replay on the rows G returns) equals the
    host finish on K1's rows, and the JAX package's host finish, at range
    4 on the off-diagonal workload: blastn (word 11, the rr_zero rule),
    megablast (word 28 over a narrower lookup word: RR probes) and
    dc-megablast with two templates."""
    genome, reads = offdiag_reads()
    db = SequenceDB.from_records([FastaRecord("chr1", "", genome)])
    opts = options_for_task(task, evalue=1e-3, window_size=40,
                            off_diagonal_range=4, **extra)
    batch = setup_batch([FastaRecord(*r) for r in reads], db, opts, "cpu")
    assert batch.seed_kw["scan_range"] == 4
    got = tseed.run_seeding(batch.seed_dev, **batch.seed_kw)
    rows, runs = _k1_rows(batch)
    if task == "megablast":
        assert tseed.probes_double_words(batch.seed_dev, batch.seed_kw)
        assert (runs >= batch.seed_kw["word_size"]).any()
    want = _host_finish(tseed, batch, rows, runs, 4)
    _equal(got, want)
    _equal(want, _host_finish(jseed, batch, rows, runs, 4))
    assert len(got) > 0


def _both_search(task, genome, reads, **kw):
    db = SequenceDB.from_records([FastaRecord("chr1", "", genome)])
    jdb = JaxDB.from_records([JaxRecord("chr1", "", genome)])
    got = _rows(torch_search([FastaRecord(*r) for r in reads], db,
                             options_for_task(task, **kw), device="cpu"))
    want = _rows(jax_search([JaxRecord(*r) for r in reads], jdb,
                            _jax_options(task, **kw)))
    return got, want


def test_search_matches_jax():
    """search() gives the JAX package's HSPs on test_off_diagonal_range's
    workload (blastn, window 40, range 4)."""
    genome, reads = offdiag_reads()
    got, want = _both_search("blastn", genome, reads, evalue=1e-3,
                             window_size=40, off_diagonal_range=4)
    assert got == want and len(got) >= 8


@pytest.mark.parametrize("scan_range", [0, 4])
def test_below_cutoff_admission(scan_range):
    """The below-cutoff workload gives the JAX package's HSPs: none at
    range 0, and at least 8 at range 4 (the probe admits them)."""
    genome, reads = below_cutoff_reads()
    got, want = _both_search("blastn", genome, reads, evalue=20.0,
                             window_size=40, dust=False,
                             off_diagonal_range=scan_range)
    assert got == want
    assert len(got) == 0 if scan_range == 0 else len(got) >= 8


def test_dc_megablast_matches_jax():
    """dc-megablast (template 18, coding) at range 4 gives the JAX
    package's HSPs."""
    genome, reads = offdiag_reads()
    got, want = _both_search("dc-megablast", genome, reads, evalue=1e-3,
                             window_size=40, off_diagonal_range=4)
    assert got == want and len(got) >= 4


def test_cli_bytes_match_jax(tmp_path):
    """blastn -window_size 40 -off_diagonal_range 4 through each CLI:
    the same bytes."""
    genome, reads = offdiag_reads()
    (tmp_path / "ref.fa").write_text(f">chr1 test\n{genome}\n")
    (tmp_path / "q.fa").write_text(
        "".join(f">{n}\n{s}\n" for n, _t, s in reads))
    assert torch_main(["makedb", "-in", str(tmp_path / "ref.fa"), "-out",
                       str(tmp_path / "db"), "-title", "t"]) == 0
    args = ["blastn", "-task", "blastn", "-query", str(tmp_path / "q.fa"),
            "-db", str(tmp_path / "db"), "-outfmt", "6", "-evalue", "1e-3",
            "-window_size", "40", "-off_diagonal_range", "4"]
    assert jax_main(args + ["-out", str(tmp_path / "j.tsv")]) == 0
    assert torch_main(args + ["-out", str(tmp_path / "t.tsv"),
                              "-device", "cpu"]) == 0
    want = (tmp_path / "j.tsv").read_text()
    assert (tmp_path / "t.tsv").read_text() == want
    assert want.count("\n") >= 8
