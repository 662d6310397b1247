"""Database sharding in the port (parallel.dist) on the CPU: the shard
plan, placement and count as pure functions; sharded searches against the
JAX package's on tests/test_dist.py's production inputs (megablast with
reads across shard boundaries, two-hit blastn, dc-megablast with each
template type, the approximate gate's lone 13-mer), on test_dbmask.py's
soft mask and test_dbindex.py's -use_index workload; sharded against
unsharded in the port (InitHits field by field at 2, 3, 4 and 8 shards,
-off_diagonal_range, -mode 2, split queries, -filtering_db, a second
batch on the cached shard forms); and two gloo processes, each writing
the bytes of the unsharded run alone (this file is their worker, run as
``python tests/test_torch_dist.py``). Exact equality throughout."""
from __future__ import annotations

import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gblastn_tpu.engine.search import search as jax_search
from gblastn_tpu.io.fasta import FastaRecord as JaxRecord
from gblastn_tpu.io.seqdb import SequenceDB as JaxDB
from gblastn_tpu_torch.cli.main import main as torch_main
from gblastn_tpu_torch.engine.resident import resident_from_reference
from gblastn_tpu_torch.engine.search import search, setup_batch
from gblastn_tpu_torch.engine.seeding import run_seeding
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.lut.dbindex import build_db_index, save_db_index
from gblastn_tpu_torch.parallel import dist
from gblastn_tpu_torch.params.options import options_for_task
from gblastn_tpu_torch.utils.profiling import slog
from tests.test_torch_search import _jax_options, _rand, _revcomp, _rows

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BASES = "ACGT"
FIELDS = ("q_off", "s_off", "q_start", "s_start", "length", "score",
          "context", "oid")
DIST_VARS = ("GBLASTN_TPU_SHARDS", "GBLASTN_TPU_BLOCK_HALO",
             "GBLASTN_TPU_STREAM", "GBLASTN_TPU_COORDINATOR",
             "GBLASTN_TPU_NUM_PROCESSES", "GBLASTN_TPU_PROCESS_ID",
             "CHUNK_SIZE")


@pytest.fixture(autouse=True)
def _no_dist_vars(monkeypatch):
    for name in DIST_VARS:
        monkeypatch.delenv(name, raising=False)


def _db(subjects):
    return SequenceDB.from_records([FastaRecord(*s) for s in subjects])


def _port_rows(reads, subjects, task, shards=None, **kw):
    """The port's search of ``reads`` on the CPU over a new database of
    ``subjects``, at ``shards`` (unset where None)."""
    if shards is None:
        os.environ.pop("GBLASTN_TPU_SHARDS", None)
    else:
        os.environ["GBLASTN_TPU_SHARDS"] = str(shards)
    try:
        return _rows(search([FastaRecord(*r) for r in reads], _db(subjects),
                            options_for_task(task, **kw), device="cpu"))
    finally:
        os.environ.pop("GBLASTN_TPU_SHARDS", None)


def _jax_rows(reads, subjects, task, **kw):
    return _rows(jax_search([JaxRecord(*r) for r in reads],
                            JaxDB.from_records([JaxRecord(*s)
                                                for s in subjects]),
                            _jax_options(task, **kw)))


def _noisy(seg, seed, rate=0.03):
    r = np.random.default_rng(seed)
    out = list(seg)
    for p in np.flatnonzero(r.random(len(seg)) < rate):
        out[p] = BASES[(BASES.index(out[p]) + 1) % 4]
    return "".join(out)


def _wobble(seg, seed):
    r = np.random.default_rng(seed)
    out = list(seg)
    for pp in range(2, len(out), 3):
        if r.random() < 0.4:
            out[pp] = BASES[(BASES.index(out[pp]) + 1 + r.integers(0, 3)) % 4]
    return "".join(out)


# ------------------------------------------------------------ pure functions
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_shard_plan_partitions_the_resident_scan(n):
    """Each shard owns a disjoint run of global stride positions from its
    buffer's halo on; together they are the resident scan's positions.
    The block is ceil(padded / n) rounded up to lcm(1024, step), the
    buffer starts a halo before it, and trailing shards may have no
    work."""
    rng = np.random.default_rng(n)
    db = _db([("a", "", _rand(rng, 9000)), ("b", "", _rand(rng, 3100)),
              ("c", "", _rand(rng, 20000))])
    length = resident_from_reference(db, torch.device("cpu")).length
    for span, step, halo in ((11, 1, 1024), (12, 4, 256), (16, 13, 4096),
                             (12, 17, 512)):
        plan = dist.shard_plan(db, n, span=span, scan_step=step, halo=halo)
        align = math.lcm(1024, step)
        assert plan.n_blocks == n and plan.halo == halo
        assert plan.B % align == 0
        assert plan.B - align < -(-db.padded_length // n) <= plan.B
        assert plan.s_buf == plan.B + 2 * halo
        owned = []
        for k in range(n):
            assert plan.slices[k][0] == k * plan.B - halo
            mine = [k * plan.B + j * step for j in range(plan.n_scan(k))]
            assert all(k * plan.B <= p < (k + 1) * plan.B for p in mine)
            assert plan.has_work(k) == bool(mine)
            owned += mine
        want = list(range(0, (length - span) // step * step + 1, step))
        assert owned == want


def test_place_shards_and_count():
    """Shard k goes to process k % world and card (k // world) % cards;
    the count is GBLASTN_TPU_SHARDS where set, else the world size, else
    the cards a bare-cuda batch sees."""
    assert dist.place_shards(4, world=1, cards=1) == [(0, 0)] * 4
    assert dist.place_shards(4, world=1, cards=2) == [(0, 0), (0, 1),
                                                      (0, 0), (0, 1)]
    assert dist.place_shards(5, world=2, cards=2) == [
        (0, 0), (1, 0), (0, 1), (1, 1), (0, 0)]
    assert dist.place_shards(4, world=2, cards=1) == [(0, 0), (1, 0),
                                                      (0, 0), (1, 0)]
    assert dist.place_shards(2, world=4, cards=8) == [(0, 0), (1, 0)]
    count = dist.shard_count
    assert count(3, world=1, cards=1) == 3
    assert count(3, world=2, cards=4) == 3
    assert count(1, world=2, cards=4) == 1
    assert count(0, world=2, cards=4) == 2
    assert count(0, world=1, cards=4) == 4
    assert count(0, world=1, cards=1) == 1
    assert count(-2, world=1, cards=1) == 1
    assert dist.batch_cards("cpu", torch.device("cpu")) == [
        torch.device("cpu")]


def test_shards_requested_reads_the_environment(monkeypatch, capsys):
    assert dist.shards_requested() == 0
    monkeypatch.setenv("GBLASTN_TPU_SHARDS", "4")
    assert dist.shards_requested() == 4
    assert "ignoring" not in capsys.readouterr().err
    monkeypatch.setenv("GBLASTN_TPU_SHARDS", "four")
    assert dist.shards_requested() == 0
    assert ("gblastn_tpu: ignoring non-numeric GBLASTN_TPU_SHARDS"
            in capsys.readouterr().err)
    assert not dist.init_distributed()          # no coordinator: no group
    assert dist.process_group() == (1, 0)


# ---------------------------------------------------- against the JAX package
def test_megablast_at_8_shards_matches_jax(monkeypatch):
    """test_dist.py's production megablast inputs, with q5 (10 kb) planted
    across the port's first shard boundary (50 kb over 8 shards, rounded
    up to lcm(1024, 13): 13,312) so that walks reach past the default
    halo and are escalated: the JAX package's unsharded HSPs, and its
    sharded ones on the 8-device CPU mesh."""
    rng = np.random.default_rng(77)
    chr1, chr2 = _rand(rng, 30000), _rand(rng, 20000)
    reads = [("q1", "", chr1[4000:4350]),
             ("q2", "", _revcomp(chr2[9000:9300])),
             ("q3", "", chr1[21000:21200] + chr2[500:700]),
             ("q4", "", chr1[6300:8700]),
             ("q5", "", chr1[8000:18000])]
    subjects = [("chr1", "", chr1), ("chr2", "", chr2)]
    kw = dict(evalue=10.0)
    want = _jax_rows(reads, subjects, "megablast", **kw)
    slog.reset()
    got = _port_rows(reads, subjects, "megablast", shards=8, **kw)
    values = dict(slog.values)
    assert got == want and len(got) >= 6
    assert values["seeding.shards"] == 8
    assert values["seeding.shard_escalated"] > 0
    monkeypatch.setenv("GBLASTN_TPU_SHARDS", "8")
    assert _jax_rows(reads, subjects, "megablast", **kw) == want


def test_two_hit_blastn_at_8_shards_matches_jax():
    rng = np.random.default_rng(101)
    genome = _rand(rng, 40000)
    reads = [("b1", "", _noisy(genome[14200:15800], 1)),
             ("b2", "", _noisy(genome[22000:23000], 2))]
    subjects = [("g", "", genome)]
    kw = dict(evalue=10.0, window_size=40)
    want = _jax_rows(reads, subjects, "blastn", **kw)
    assert _port_rows(reads, subjects, "blastn", shards=8, **kw) == want
    assert len(want) >= 2


@pytest.mark.parametrize("template_type,seed",
                         [("coding", 202), ("coding_and_optimal", 303)])
def test_dc_megablast_at_8_shards_matches_jax(template_type, seed):
    """A diverged read across the shard boundary at 15,360 (40 kb over 8
    shards of 5,120), with one template and with both."""
    rng = np.random.default_rng(seed)
    genome = _rand(rng, 40000)
    reads = [("d1", "", _wobble(genome[14700:15400], 1)),
             ("d2", "", _wobble(genome[30000:30500], 2))]
    subjects = [("g", "", genome)]
    kw = dict(evalue=1e-3, template_type=template_type)
    want = _jax_rows(reads, subjects, "dc-megablast", **kw)
    assert _port_rows(reads, subjects, "dc-megablast", shards=8,
                      **kw) == want
    assert len(want) >= 2


@pytest.mark.parametrize("seed,expect_hits", [(4, 0), (0, 1)])
def test_approx_gate_at_8_shards_matches_jax(seed, expect_hits):
    """A lone exact 13-mer whose approximate score misses the reduced
    cutoff (seed 4) or passes it (seed 0)."""
    rng = np.random.default_rng(seed)
    g = _rand(rng, 30000)
    q = _rand(rng, 500)
    pos = int(rng.integers(100, 29000))
    reads = [("q", "", q)]
    subjects = [("s", "", g[:pos] + q[200:213] + g[pos:])]
    kw = dict(evalue=1.0, word_size=12, dust=False)
    want = _jax_rows(reads, subjects, "blastn", **kw)
    assert len(want) == expect_hits
    assert _port_rows(reads, subjects, "blastn", shards=8, **kw) == want


def test_soft_mask_at_4_shards_matches_jax(monkeypatch):
    """test_dbmask.py's: [8000, 9000) soft-masked; the read inside finds
    nothing, the read outside its locus."""
    g = _rand(np.random.default_rng(7), 24000)
    reads = [("q_in", "", g[8200:8500]), ("q_out", "", g[2000:2300])]
    dbs = []
    for cls, rec in ((SequenceDB, FastaRecord), (JaxDB, JaxRecord)):
        db = cls.from_records([rec("s1", "subject", g)], title="t")
        db.add_mask_set(55, "repeat", "test", {"s1": [(8000, 9000)]})
        dbs.append(db)
    kw = dict(evalue=1e-3, dust=False, db_soft_mask=55)
    want = _rows(jax_search([JaxRecord(*r) for r in reads], dbs[1],
                            _jax_options("megablast", **kw)))
    monkeypatch.setenv("GBLASTN_TPU_SHARDS", "4")
    got = _rows(search([FastaRecord(*r) for r in reads], dbs[0],
                       options_for_task("megablast", **kw), device="cpu"))
    assert got == want
    assert {r[0] for r in got} == {1}


def test_use_index_at_4_shards_matches_jax(tmp_path, monkeypatch):
    """test_dbindex.py's: a 60 kb genome as two subjects with an index at
    word 28 (LUT width 12); the shards take their slices of the index."""
    from tests.test_torch_dbindex import _reads

    rng = np.random.default_rng(31)
    genome = _rand(rng, 60000)
    SequenceDB.from_records(
        [FastaRecord("c1", "", genome[:40000]),
         FastaRecord("c2", "", genome[40000:])], title="idxdb",
    ).save(tmp_path / "db")
    db = SequenceDB.load(tmp_path / "db")
    save_db_index(build_db_index(db, 28, 12), str(tmp_path / "db"))
    reads = _reads(rng, genome, 12, 700)
    kw = dict(evalue=1e-5, max_target_seqs=20, lut_word_size=12,
              use_index=True)
    want = _rows(jax_search([JaxRecord(*r) for r in reads],
                            JaxDB.load(tmp_path / "db"),
                            _jax_options("megablast", **kw)))
    monkeypatch.setenv("GBLASTN_TPU_SHARDS", "4")
    b = setup_batch([FastaRecord(*r) for r in reads], db,
                    options_for_task("megablast", **kw), "cpu")
    assert b.shards is not None and b.shards.blocks.index_slices is not None
    got = _rows(search([FastaRecord(*r) for r in reads], db,
                       options_for_task("megablast", **kw), device="cpu"))
    assert got == want and len(got) >= 6


# ---------------------------------------------------------- against itself
@pytest.fixture(scope="module")
def planted():
    """A 40 kb genome as three subjects, with exact 1.2 kb reads across
    shard boundaries at every shard count tested (14,336 and 20,480 for
    blastn, 21,504 for megablast at two shards), mutated reads on both
    strands and noise."""
    rng = np.random.default_rng(12)
    g = _rand(rng, 40000)
    reads = [(f"x{c}", "", g[c - 600: c + 600])
             for c in (14336, 20480, 21504)]
    reads += [("m1", "", _noisy(g[5000:6000], 3, 0.04)),
              ("m2", "", _revcomp(_noisy(g[29500:30500], 4, 0.02))),
              ("noise", "", _rand(rng, 400))]
    return reads, [("s1", "", g[:15000]), ("s2", "", g[15000:32000]),
                   ("s3", "", g[32000:])]


SHAPES = {
    # name: (task, options)
    "megablast": ("megablast", {}),
    "two_hit_rr": ("megablast", {"window_size": 40}),
    "off_diagonal": ("blastn", {"window_size": 40, "off_diagonal_range": 2}),
}


@pytest.fixture(scope="module")
def resident_hits(planted):
    """The resident run_seeding's InitHits of each shape."""
    reads, subjects = planted
    db = _db(subjects)
    out = {}
    for name, (task, kw) in SHAPES.items():
        b = setup_batch([FastaRecord(*r) for r in reads], db,
                        options_for_task(task, evalue=1e-3, **kw), "cpu")
        assert b.shards is None and b.stream is None
        out[name] = run_seeding(b.seed_dev, **b.seed_kw)
    return out


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_sharded_init_hits_equal_resident(planted, resident_hits,
                                          monkeypatch, n):
    """Sharded seeding gives the resident run_seeding's InitHits, field
    by field: one-hit megablast, two-hit megablast (RR probes) and
    two-hit blastn with -off_diagonal_range 2 (the host replay), with a
    halo of 256 so that walks across the shards' edges are escalated."""
    reads, subjects = planted
    db = _db(subjects)
    monkeypatch.setenv("GBLASTN_TPU_SHARDS", str(n))
    monkeypatch.setenv("GBLASTN_TPU_BLOCK_HALO", "256")
    escalated = 0
    for name, (task, kw) in SHAPES.items():
        b = setup_batch([FastaRecord(*r) for r in reads], db,
                        options_for_task(task, evalue=1e-3, **kw), "cpu")
        assert b.shards is not None and b.seed_dev.resident is None
        assert b.stream is None
        slog.reset()
        got = dist.run_seeding_sharded(b.shards, b.seed_dev, **b.seed_kw)
        want = resident_hits[name]
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{name}: {f}")
        assert len(got) >= 3
        assert slog.values["seeding.shards"] == n
        escalated += slog.values["seeding.shard_escalated"]
    assert escalated > 0
    assert not hasattr(db, "_torch_resident")


def test_second_batch_reuses_the_shard_forms(planted, monkeypatch):
    """A second batch on the same database takes the cached shard forms
    (the same tensor objects) and uploads nothing."""
    reads, subjects = planted
    db = _db(subjects)
    opts = options_for_task("blastn", evalue=1e-3)
    monkeypatch.setenv("GBLASTN_TPU_SHARDS", "4")
    slog.reset()
    b1 = setup_batch([FastaRecord(*reads[0])], db, opts, "cpu")
    assert "setup.shard_upload" in slog.totals
    slog.reset()
    b2 = setup_batch([FastaRecord(*reads[1])], db, opts, "cpu")
    assert "setup.shard_upload" not in slog.totals
    assert list(b1.shards.forms) == list(b2.shards.forms) == [0, 1, 2, 3]
    for k, (res, _index) in b2.shards.forms.items():
        assert res is b1.shards.forms[k][0]
        assert res.packed is b1.shards.forms[k][0].packed
    assert not hasattr(db, "_torch_resident")


def test_cli_mode2_split_and_filtering_db(planted, tmp_path, monkeypatch):
    """Through the CLI at 4 shards: -mode 2 and -mode 1, a query split
    into chunks, and -filtering_db (whose nested search is sharded too)
    each write the bytes of the unsharded run."""
    reads, subjects = planted
    (tmp_path / "q.fa").write_text("".join(f">{r[0]}\n{r[2]}\n"
                                           for r in reads))
    _db(subjects).save(tmp_path / "db")
    _db([("rep", "a repeat", reads[2][2])]).save(tmp_path / "rep")
    base = ["blastn", "-query", str(tmp_path / "q.fa"), "-db",
            str(tmp_path / "db"), "-outfmt", "6", "-device", "cpu",
            "-evalue", "1e-3"]
    runs = {"mode1": [], "mode2": ["-mode", "2"],
            "split": [], "filtering": ["-filtering_db", str(tmp_path / "rep")]}

    def run(tag, shards):
        if tag == "split":
            monkeypatch.setenv("CHUNK_SIZE", "2500")
        if shards:
            monkeypatch.setenv("GBLASTN_TPU_SHARDS", shards)
        out = tmp_path / f"{tag}_{shards}.tsv"
        try:
            assert torch_main(base + runs[tag] + ["-out", str(out)]) == 0
        finally:
            monkeypatch.delenv("CHUNK_SIZE", raising=False)
            monkeypatch.delenv("GBLASTN_TPU_SHARDS", raising=False)
        return out.read_bytes()

    for tag in runs:
        slog.reset()
        got = run(tag, "4")
        assert slog.values["seeding.shards"] == (8 if tag == "filtering"
                                                 else 4)
        assert got == run(tag, None), tag
        assert got.count(b"\n") >= 4
    assert run("filtering", None) != run("mode1", None)


# ----------------------------------------------------------- across processes
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_write_the_unsharded_bytes(planted, tmp_path):
    """Two ranks over gloo on localhost at 4 shards (two each), both on
    the CPU, beside a process alone and unsharded: each rank's -outfmt 6
    and -outfmt 11 bytes equal those of the process alone (the archive
    holds the search's diagnostics, so the ranks' lookup hits are
    summed)."""
    reads, subjects = planted
    (tmp_path / "q.fa").write_text("".join(f">{r[0]}\n{r[2]}\n"
                                           for r in reads))
    _db(subjects).save(tmp_path / "db")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    rank = {**env, "GBLASTN_TPU_SHARDS": "4",
            "GBLASTN_TPU_COORDINATOR": f"localhost:{_free_port()}",
            "GBLASTN_TPU_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), str(tmp_path), tag],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=e)
        for tag, e in (("alone", env),
                       ("rank0", {**rank, "GBLASTN_TPU_PROCESS_ID": "0"}),
                       ("rank1", {**rank, "GBLASTN_TPU_PROCESS_ID": "1"}))]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log, want in zip(procs, logs, ("shards 0 world 1",
                                          "shards 4 world 2",
                                          "shards 4 world 2")):
        assert p.returncode == 0, log[-3000:]
        assert want in log, log[-3000:]
    for fmt in ("6", "11"):
        alone = (tmp_path / f"alone.{fmt}").read_bytes()
        for r in (0, 1):
            got = (tmp_path / f"rank{r}.{fmt}").read_bytes()
            assert got == alone, (r, fmt)
    assert alone.count(b"Number of Hits to DB") == 1
    assert (tmp_path / "alone.6").read_bytes().count(b"\n") >= 4


def test_unreachable_coordinator_raises(tmp_path):
    """A rank whose coordinator never comes raises after the timeout; it
    does not search alone."""
    prog = ("import sys\n"
            "from gblastn_tpu_torch.parallel import dist\n"
            "try:\n"
            "    dist.init_distributed(timeout=1.0)\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__)\n"
            "    sys.exit(0)\n"
            "print('JOINED')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "GBLASTN_TPU_COORDINATOR": f"localhost:{_free_port()}",
           "GBLASTN_TPU_NUM_PROCESSES": "2", "GBLASTN_TPU_PROCESS_ID": "1"}
    r = subprocess.run([sys.executable, "-c", prog], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "RAISED" in r.stdout, r.stdout + r.stderr


def _worker_search(tmp, tag: str) -> bytes:
    """The CLI's -outfmt 6 and -outfmt 11 searches of ``tmp``'s reads on
    the CPU, to ``tmp/<tag>.6`` and ``tmp/<tag>.11``; the -outfmt 6
    bytes."""
    args = ["blastn", "-query", str(tmp / "q.fa"), "-db", str(tmp / "db"),
            "-device", "cpu", "-evalue", "1e-3"]
    for fmt in ("6", "11"):
        if torch_main(args + ["-outfmt", fmt, "-out",
                              str(tmp / f"{tag}.{fmt}")]) != 0:
            raise SystemExit(f"{tag}: -outfmt {fmt} failed")
    return (tmp / f"{tag}.6").read_bytes()


if __name__ == "__main__":
    # a rank of test_two_gloo_processes_write_the_unsharded_bytes
    _worker_search(Path(sys.argv[1]), sys.argv[2])
    print(f"shards {dist.shards_requested()} world "
          f"{dist.process_group()[0]}")
