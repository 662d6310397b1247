"""The port's pipelined mode (-mode 0/2) against its sequential mode and
against gblastn_tpu's pipelined mode (tests/test_pipeline.py's shape):
the same HSPs in the same order, errors propagate, a query longer than
the chunk is searched whole (as the JAX package's pipeline does), and
the launch generators yield before their one wait with no span open
across the yield. Runs the port on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import gblastn_tpu.cli.main as jax_cli
import gblastn_tpu_torch.cli.main as torch_cli
import gblastn_tpu_torch.engine.seeding as es
from gblastn_tpu_torch.engine.pipeline import run_pipelined_search
from gblastn_tpu_torch.engine.search import (
    prelim_search_steps,
    search,
    setup_batch,
)
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.params.options import megablast_options
from gblastn_tpu_torch.utils.profiling import slog
from tests.test_torch_search import BASES, _rand, _revcomp
from tests.test_torch_split import mosaic

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """A 40 kb genome; four batches of three 400-base reads (every third
    reverse-complemented), and for dc-megablast twelve reads with a
    third of their third positions changed."""
    rng = np.random.default_rng(313)
    genome = _rand(rng, 40000)
    reads = []
    for k in range(12):
        start = 1000 + k * 2500
        s = genome[start: start + 400]
        reads.append((f"q{k // 3}_{k % 3}", s if k % 3 else _revcomp(s)))
    wobbled = []
    for k in range(12):
        start = int(rng.integers(0, len(genome) - 500))
        frag = list(genome[start: start + 400])
        for p in range(2, len(frag), 3):
            if rng.random() < 0.35:
                frag[p] = BASES[(BASES.index(frag[p]) + 1
                                 + int(rng.integers(0, 3))) % 4]
        wobbled.append((f"d{k}", "".join(frag)))
    db = SequenceDB.from_records([FastaRecord("c", "", genome)])
    return dict(genome=genome, reads=reads, wobbled=wobbled, db=db,
                batches=[[FastaRecord(n, "", s) for n, s in reads[i:i + 3]]
                         for i in range(0, 12, 3)])


def summarize(results):
    out = []
    for qres in results.queries:
        qid = results.qblock.ids[qres.query_index]
        for lst in qres.hsplists:
            for h in lst.hsps:
                out.append((qid, lst.oid, h.q_off, h.q_end, h.s_off,
                            h.s_end, h.score, round(h.evalue, 12)))
    return out


def test_pipeline_matches_sequential(setup):
    db, batches = setup["db"], setup["batches"]
    opts = megablast_options(evalue=1e-6)
    seq = []
    for b in batches:
        seq.extend(summarize(search(b, db, opts, device="cpu")))
    piped = []
    n = run_pipelined_search(iter(batches), db, opts,
                             lambda r: piped.extend(summarize(r)),
                             device="cpu")
    assert n == len(batches)
    assert len(seq) == 12
    assert piped == seq


def test_pipeline_propagates_errors(setup):
    db, batches = setup["db"], setup["batches"]

    def bad_batches():
        yield batches[0]
        raise RuntimeError("reader exploded")

    with pytest.raises(RuntimeError, match="reader exploded"):
        run_pipelined_search(bad_batches(), db, megablast_options(),
                             lambda r: None, device="cpu")
    seen = []

    def bad_sink(results):
        seen.append(results)
        raise ValueError("sink exploded")

    with pytest.raises(ValueError, match="sink exploded"):
        run_pipelined_search(iter(batches), db, megablast_options(),
                             bad_sink, device="cpu")
    assert len(seen) == 1


def _cli_runs(tmp_path, monkeypatch, reads, extra):
    """-outfmt 6 bytes of the port's -mode 1 and -mode 2 and of the JAX
    package's -mode 2, with CLI batches of 1,200 residues (three reads)
    in both CLIs."""
    for mod in (jax_cli, torch_cli):
        monkeypatch.setattr(mod, "BATCH_SIZE_MEGABLAST", 1200)
        monkeypatch.setattr(mod, "BATCH_SIZE_BLASTN", 1200)
    q = tmp_path / "q.fa"
    q.write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    args = ["blastn", *extra, "-query", str(q), "-db", str(tmp_path / "db"),
            "-outfmt", "6"]
    out = {}
    for name, main, more in (("mode1", torch_cli.main, ["-mode", "1"]),
                             ("mode2", torch_cli.main, ["-mode", "2"]),
                             ("jax2", jax_cli.main, ["-mode", "2"])):
        dev = ["-device", "cpu"] if main is torch_cli.main else []
        assert main(args + more + dev
                    + ["-out", str(tmp_path / f"{name}.tsv")]) == 0
        out[name] = (tmp_path / f"{name}.tsv").read_bytes()
    return out


@pytest.mark.parametrize("task", ["megablast", "dc-megablast"])
def test_mode2_bytes_match_mode1_and_jax(setup, tmp_path, monkeypatch, task):
    setup["db"].save(tmp_path / "db")
    reads = setup["reads"] if task == "megablast" else setup["wobbled"]
    out = _cli_runs(tmp_path, monkeypatch, reads, ["-task", task])
    assert out["mode2"] == out["mode1"] == out["jax2"]
    assert len({ln.split(b"\t")[0] for ln in out["mode1"].splitlines()}) >= 9


def test_mode2_searches_a_long_query_whole(setup, tmp_path, monkeypatch):
    """A query longer than CHUNK_SIZE: -mode 2 gives the JAX package's
    -mode 2 bytes, which are those of the query searched unsplit, and
    splits nothing (the JAX package's prelim_search_steps does not split;
    -mode 1 does)."""
    import gblastn_tpu_torch.engine.split as split_mod

    setup["db"].save(tmp_path / "db")
    rng = np.random.default_rng(8)
    long_q, _ = mosaic(rng, setup["genome"], 12000)
    reads = [("long", long_q)] + setup["reads"][:2]
    whole = _cli_runs(tmp_path, monkeypatch, reads, [])
    monkeypatch.setenv("CHUNK_SIZE", "5000")
    splits = []
    split_records = split_mod.split_records

    def spy(records, chunk, overlap):
        out = split_records(records, chunk, overlap)
        splits.append(out[2])
        return out

    monkeypatch.setattr(split_mod, "split_records", spy)
    out = _cli_runs(tmp_path, monkeypatch, reads, [])
    assert out["mode2"] == out["jax2"] == whole["mode1"]
    assert out["mode2"].count(b"\n") >= 20
    # -mode 1's two batches (one holds the long query) split once
    assert splits == [True, False]


def test_generators_yield_before_the_wait(setup, monkeypatch):
    """run_seeding_steps yields after the device finish is launched and
    before the nonzero of R's saved seeds; prelim_search_steps yields
    once, with its device.seeding span closed on both sides of it."""
    db, batch = setup["db"], setup["batches"][0]
    opts = megablast_options()
    saved, waits = [], []
    finish, nonzero = es.device_finish, torch.nonzero

    def spy_finish(*args, **kw):
        out = finish(*args, **kw)
        saved.append(out[2])
        return out

    def spy_nonzero(t, *args, **kw):
        if saved and t is saved[-1]:
            waits.append(len(saved))
        return nonzero(t, *args, **kw)

    monkeypatch.setattr(es, "device_finish", spy_finish)
    monkeypatch.setattr(torch, "nonzero", spy_nonzero)
    b = setup_batch(batch, db, opts, "cpu")
    gen = es.run_seeding_steps(b.seed_dev, **b.seed_kw)
    next(gen)
    assert len(saved) == 1 and waits == []
    init = es.drive(gen)
    assert waits == [1] and len(init) == 3
    assert es.run_seeding(b.seed_dev, **b.seed_kw).s_off.tolist() == \
        init.s_off.tolist()

    slog.reset()
    gen = prelim_search_steps(batch, db, opts, "cpu")
    next(gen)
    assert len(saved) == 3 and waits == [1, 2]
    assert slog.counts["device.seeding"] == 1
    with pytest.raises(StopIteration) as stop:
        next(gen)
    assert waits == [1, 2, 3]
    assert slog.counts["device.seeding"] == 2
    assert len(stop.value.value.hitlists) == 3
