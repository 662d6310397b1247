"""The port's search and CLI against gblastn_tpu's on planted workloads.

Each package builds its own ``SequenceDB`` from the same records. Every
HSP field, e-value and bit score included, must match; the -outfmt 6
bytes of the two CLIs must be identical. Runs the port on the CPU (its
plain PyTorch path)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import gblastn_tpu.engine.search as jes
import gblastn_tpu_torch.engine.search as tes
from gblastn_tpu.cli.main import main as jax_main
from gblastn_tpu.engine.search import search as jax_search
from gblastn_tpu.io.fasta import FastaRecord as JaxRecord
from gblastn_tpu.io.seqdb import SequenceDB as JaxDB
from gblastn_tpu.ops.seeding import subject_arrays_from_packed
from gblastn_tpu.params import options as jax_options
from gblastn_tpu_torch.cli.main import main as torch_main
from gblastn_tpu_torch.engine.resident import resident_from_reference
from gblastn_tpu_torch.engine.search import search as torch_search
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.params.options import (
    ExtensionMethod,
    blastn_options,
    megablast_options,
    options_for_task,
)

# the plain versions run many small ops: on the CPU one thread beats a pool
torch.set_num_threads(1)

BASES = "ACGT"


def _rand(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def _revcomp(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    return "".join(comp[c] for c in reversed(s))


def _jax_options(task, **kw):
    """The JAX package's options for ``task`` with the same overrides
    (enum values mapped to its own enums)."""
    kw = {k: (jax_options.ExtensionMethod(v.value)
              if isinstance(v, ExtensionMethod) else v)
          for k, v in kw.items()}
    return jax_options.options_for_task(task, **kw)


def _both(subjects, reads, title):
    """Each package's SequenceDB and query records, built from the same
    (id, title, sequence) tuples."""
    return dict(
        jdb=JaxDB.from_records([JaxRecord(*s) for s in subjects],
                               title=title),
        db=SequenceDB.from_records([FastaRecord(*s) for s in subjects],
                                   title=title),
        jreads=[JaxRecord(*r) for r in reads],
        reads=[FastaRecord(*r) for r in reads],
    )


@pytest.fixture(scope="module")
def workload():
    """tests/test_search_e2e.py's planted reads over two subjects: plus
    and minus strand, substitutions, a deletion, a read of subject 2, an
    N in a query, a dust-masked low-complexity prefix, no-hit noise."""
    rng = np.random.default_rng(42)
    g1, g2 = _rand(rng, 20000), _rand(rng, 12000)
    subst = list(g1[1000:1400])
    for pos in (100, 200, 300):
        subst[pos] = BASES[(BASES.index(subst[pos]) + 1) % 4]
    with_n = list(g2[6000:6300])
    with_n[150] = "N"
    reads = [
        ("plus", "exact plus", g1[5000:5200]),
        ("minus", "", _revcomp(g1[8000:8150])),
        ("subst", "", "".join(subst)),
        ("del", "", g1[2000:2200] + g1[2204:2400]),
        ("sub2", "", g2[3000:3300]),
        ("withN", "", "".join(with_n)),
        ("dusty", "", "AC" * 30 + g1[12000:12200]),
        ("noise", "", _rand(rng, 80)),
    ]
    return _both([("chr1", "synthetic chromosome", g1),
                  ("chr2", "second subject", g2)], reads, "testdb")


@pytest.fixture(scope="module")
def blastn_workload():
    """-task blastn: 20 reads of 1.5 kb from a 200 kb genome with 3%
    substitutions, one with a 6-base deletion, one with a run of N, one
    reverse-complemented (minus strand)."""
    rng = np.random.default_rng(2026)
    genome = _rand(rng, 200_000)
    reads = []
    for k in range(20):
        st = int(rng.integers(0, len(genome) - 1600))
        read = list(genome[st: st + 1500])
        for p in np.flatnonzero(rng.random(1500) < 0.03):
            read[p] = BASES[(BASES.index(read[p]) + 1
                             + int(rng.integers(0, 3))) % 4]
        s = "".join(read)
        if k == 3:
            s = s[:700] + s[706:]
        if k == 5:
            s = s[:300] + "N" * 5 + s[305:]
        if k == 7:
            s = _revcomp(s)
        reads.append((f"r{k}", "", s))
    return _both([("g", "synthetic 200 kb genome", genome)], reads,
                 "blastn200k")


def _rows(res):
    """(query, oid, best e-value, every HSP field) in result order; the
    two packages' HSP classes differ, so fields compare, not objects."""
    def fields(h):
        return tuple((k, list(v) if k == "edit_script" and v is not None
                      else v) for k, v in vars(h).items())

    return [
        (q.query_index, lst.oid, lst.best_evalue, fields(h))
        for q in res.queries for lst in q.hsplists for h in lst.hsps
    ]


def test_resident_forms_match_jax(workload):
    db, jdb = workload["db"], workload["jdb"]
    res = resident_from_reference(db, torch.device("cpu"))
    starts = np.asarray(jdb.starts)
    ends = starts + np.asarray(jdb.lengths)
    sub2, valid, sw = subject_arrays_from_packed(
        jdb.packed_padded(), starts, ends)
    np.testing.assert_array_equal(res.subject2.numpy(), np.asarray(sub2))
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(res.valid.numpy(), jdb.valid_mask())
    np.testing.assert_array_equal(res.subject_w.numpy(),
                                  np.asarray(sw).astype(np.int64))
    np.testing.assert_array_equal(res.packed.numpy(), jdb.packed_padded())
    assert resident_from_reference(db, torch.device("cpu")) is res
    assert not hasattr(db, "_device_cache")


@pytest.mark.parametrize("opts", [
    dict(),
    dict(evalue=1e-5, max_target_seqs=1, dust=False),
    dict(strand="minus"),
    dict(gapped=False),
    dict(query_loc=(20, 180), mask_at_hash=False),
    dict(culling_limit=1, num_threads=2),
    dict(reward=2, penalty=-3, gap_open=5, gap_extend=2,
         extension_method=ExtensionMethod.DYN_PROG),
], ids=["defaults", "evalue-dust-off", "minus", "ungapped",
        "query_loc-hard-mask", "culling-threads", "dynprog"])
def test_search_matches_jax(workload, opts):
    w = workload
    want = jax_search(w["jreads"], w["jdb"],
                      _jax_options("megablast", **opts))
    got = torch_search(w["reads"], w["db"], megablast_options(**opts),
                       device="cpu")
    assert _rows(got) == _rows(want)
    hit = {q.query_index for q in got.queries if q.hsplists}
    assert 7 not in hit                          # noise finds nothing
    if not opts:
        assert hit == {0, 1, 2, 3, 4, 5, 6}      # every planted read
    else:
        assert hit


def _capture_init(monkeypatch, module, into):
    """Record the InitHits that ``module``'s search hands its prelim."""
    orig = module.run_gapped_prelim

    def capture(init, *args, **kw):
        into.append(init)
        return orig(init, *args, **kw)

    monkeypatch.setattr(module, "run_gapped_prelim", capture)


def test_blastn_search_matches_jax(blastn_workload, monkeypatch):
    """-task blastn (word 11, lut width 11, DP extension): the port's
    InitHits equal the JAX package's field by field, and so do the final
    results, with the device gapped filter off and forced on."""
    w = blastn_workload
    jinit, tinit = [], []
    _capture_init(monkeypatch, jes, jinit)
    _capture_init(monkeypatch, tes, tinit)
    monkeypatch.setenv("GBLASTN_TPU_GAPPED_FILTER", "0")
    want = _rows(jax_search(w["jreads"], w["jdb"],
                            _jax_options("blastn", evalue=1e-5)))
    options = blastn_options(evalue=1e-5)
    got = _rows(torch_search(w["reads"], w["db"], options, device="cpu"))
    for f in dataclasses.fields(jinit[0]):
        np.testing.assert_array_equal(np.asarray(getattr(tinit[0], f.name)),
                                      np.asarray(getattr(jinit[0], f.name)),
                                      err_msg=f.name)
    assert len(jinit[0]) > 20
    assert got == want
    assert {r[0] for r in got} == set(range(20))     # every read hits
    monkeypatch.setenv("GBLASTN_TPU_GAPPED_FILTER", "1")
    assert _rows(torch_search(w["reads"], w["db"], options,
                              device="cpu")) == want


@pytest.mark.parametrize("task", ["megablast", "blastn"])
def test_cli_outfmt6_bytes_match_jax(workload, blastn_workload, tmp_path,
                                     task):
    w = workload if task == "megablast" else blastn_workload
    (tmp_path / "q.fa").write_text("".join(
        f">{r.seq_id} {r.title}\n{r.sequence}\n" for r in w["reads"]))
    w["db"].save(tmp_path / "db")
    args = ["blastn", "-task", task, "-query", str(tmp_path / "q.fa"),
            "-db", str(tmp_path / "db"), "-outfmt", "6"]
    assert jax_main(args + ["-out", str(tmp_path / "jax.tsv")]) == 0
    assert torch_main(args + ["-out", str(tmp_path / "torch.tsv"),
                              "-device", "cpu"]) == 0
    want = (tmp_path / "jax.tsv").read_bytes()
    assert want.count(b"\n") >= (7 if task == "megablast" else 20)
    assert (tmp_path / "torch.tsv").read_bytes() == want


def test_outside_the_slice_refuses(workload, monkeypatch):
    """Nothing is outside the port any more: two-hit seeding with
    -off_diagonal_range (tests/test_torch_offdiag.py), and sharding
    (GBLASTN_TPU_SHARDS=2, tests/test_torch_dist.py) searches and gives
    the unsharded run's HSPs."""
    db, reads = workload["db"], workload["reads"]
    for options in (blastn_options(window_size=40, off_diagonal_range=2),
                    options_for_task("dc-megablast", off_diagonal_range=1)):
        assert torch_search(reads[:1], db, options, device="cpu").queries
    want = _rows(torch_search(reads, db, megablast_options(), device="cpu"))
    monkeypatch.setenv("GBLASTN_TPU_SHARDS", "2")
    got = _rows(torch_search(reads, db, megablast_options(), device="cpu"))
    assert got == want and len(want) >= 7


@pytest.mark.parametrize("value", ["x", ""])
def test_non_numeric_shards_are_ignored(workload, tmp_path, monkeypatch,
                                        capsys, value):
    """GBLASTN_TPU_SHARDS that is not a number (or empty) is ignored with
    the reference's note on stderr (gblastn_tpu/engine/search.py:486-493),
    and the search writes the bytes of a run without it."""
    (tmp_path / "q.fa").write_text("".join(
        f">{r.seq_id} {r.title}\n{r.sequence}\n" for r in workload["reads"]))
    workload["db"].save(tmp_path / "db")
    args = ["blastn", "-query", str(tmp_path / "q.fa"), "-db",
            str(tmp_path / "db"), "-outfmt", "6", "-device", "cpu"]
    monkeypatch.delenv("GBLASTN_TPU_SHARDS", raising=False)
    assert torch_main(args + ["-out", str(tmp_path / "unset.tsv")]) == 0
    assert "GBLASTN_TPU_SHARDS" not in capsys.readouterr().err
    monkeypatch.setenv("GBLASTN_TPU_SHARDS", value)
    assert torch_main(args + ["-out", str(tmp_path / "set.tsv")]) == 0
    assert ("gblastn_tpu: ignoring non-numeric GBLASTN_TPU_SHARDS"
            in capsys.readouterr().err)
    want = (tmp_path / "unset.tsv").read_bytes()
    assert want.count(b"\n") >= 7
    assert (tmp_path / "set.tsv").read_bytes() == want
