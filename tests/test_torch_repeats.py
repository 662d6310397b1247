"""The port's repeat filtering (-filtering_db) against gblastn_tpu's
(tests/test_repeats.py's shape): the nested blastn search against a
repeat database gives the JAX package's masks on plus and minus copies,
runs on the device it was given, and the filtered search gives the JAX
package's HSPs and -outfmt 6 bytes. Runs the port on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import gblastn_tpu_torch.engine.resident as resident_mod
import gblastn_tpu_torch.engine.search as tes
from gblastn_tpu.cli.main import main as jax_main
from gblastn_tpu.engine.search import search as jax_search
from gblastn_tpu.io.fasta import FastaRecord as JaxRecord
from gblastn_tpu.io.seqdb import SequenceDB as JaxDB
from gblastn_tpu.masking.repeats import find_repeat_masks as jax_masks
from gblastn_tpu_torch.cli.main import main as torch_main
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.masking.repeats import (
    combine_intervals,
    find_repeat_masks,
    load_repeat_db,
    repeats_search_options,
)
from gblastn_tpu_torch.params.options import megablast_options
from tests.test_torch_search import _jax_options, _rand, _revcomp, _rows

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 20 kb genome with a 300-base repeat element inserted at 8,000
    (so an unfiltered search aligns a query's copy of it), the element
    and a second one as the repeat database (saved once, loaded by each
    package), and reads: a unique flank followed by the element, and
    plus and minus copies inside random flanks."""
    rng = np.random.default_rng(21)
    elem, elem2 = _rand(rng, 300), _rand(rng, 300)
    core = _rand(rng, 20000)
    genome = core[:8000] + elem + core[8000:]
    path = tmp_path_factory.mktemp("repeats") / "repdb"
    SequenceDB.from_records(
        [FastaRecord("rep1", "a repeat element", elem),
         FastaRecord("rep2", "another element", elem2)],
        title="repeats").save(path)
    reads = [("flank", "", core[3000:3400] + elem),
             ("qp", "", _rand(rng, 150) + elem + _rand(rng, 150)),
             ("qm", "", _rand(rng, 100) + _revcomp(elem) + _rand(rng, 100)),
             ("both", "", core[12000:12300] + _revcomp(elem2)
              + core[14000:14200])]
    return dict(
        path=str(path), genome=genome, reads=reads,
        db=SequenceDB.from_records([FastaRecord("chr1", "", genome)],
                                   title="main"),
        jdb=JaxDB.from_records([JaxRecord("chr1", "", genome)],
                               title="main"),
    )


def test_repeat_helpers_are_the_references():
    assert combine_intervals([(0, 10), (14, 20)]) == [(0, 20)]
    assert combine_intervals([(0, 10), (15, 20)]) == [(0, 10), (15, 20)]
    o = repeats_search_options()
    assert (o.reward, o.penalty, o.gap_open, o.gap_extend) == (1, -1, 2, 1)
    assert (o.word_size, o.cutoff_score, o.dust) == (11, 26, False)


def test_find_repeat_masks_match_jax(setup, monkeypatch):
    """Plus and minus copies: the JAX package's masks, from a nested
    search on the device the caller gave."""
    seen = []
    nested = tes.search

    def spy(*args, **kw):
        seen.append(kw.get("device"))
        return nested(*args, **kw)

    monkeypatch.setattr(tes, "search", spy)
    reads = setup["reads"]
    got = find_repeat_masks([FastaRecord(*r) for r in reads],
                            load_repeat_db(setup["path"]), device="cpu")
    want = jax_masks([JaxRecord(*r) for r in reads],
                     JaxDB.load(setup["path"]))
    assert got == want
    assert seen == ["cpu"]
    assert got[1] == [(150, 449)] and got[2] == [(100, 399)]
    assert got[0] == [(400, 699)] and got[3] == [(300, 599)]


def test_filtered_search_matches_jax(setup, monkeypatch):
    """search() with -filtering_db: the JAX package's HSPs; the nested
    search runs on the batch's device, and over two batches each
    database is uploaded once."""
    reads = setup["reads"]
    genome = setup["genome"]
    db = SequenceDB.from_records([FastaRecord("chr1", "", genome)],
                                 title="main")
    opts = dict(filtering_db=setup["path"])
    uploads, devices = [], []
    pack = resident_mod.pack_subject_words
    nested = tes.search

    def count(packed):
        uploads.append(int(packed.numel()))
        return pack(packed)

    def spy(*args, **kw):
        devices.append(kw.get("device"))
        return nested(*args, **kw)

    monkeypatch.setattr(resident_mod, "pack_subject_words", count)
    rep = load_repeat_db(setup["path"])    # cached: one object a path
    fresh = not getattr(rep, "_torch_resident", None)
    halves = (reads[:2], reads[2:])
    want, plain = [], []
    for half in halves:
        want += _rows(jax_search([JaxRecord(*r) for r in half],
                                 setup["jdb"],
                                 _jax_options("megablast", **opts)))
        plain += _rows(jax_search([JaxRecord(*r) for r in half],
                                  setup["jdb"], _jax_options("megablast")))
    monkeypatch.setattr(tes, "search", spy)
    got = []
    for half in halves:
        got += _rows(nested([FastaRecord(*r) for r in half], db,
                            megablast_options(**opts), device="cpu"))
    # the main db once, the repeat db once (unless an earlier search
    # already left it resident), each cached on its own SequenceDB
    assert len(uploads) == 1 + fresh
    assert list(db._torch_resident) == [torch.device("cpu")]
    assert list(rep._torch_resident) == [torch.device("cpu")]
    assert devices.count(torch.device("cpu")) == 2   # nested, per batch
    assert got == want
    assert want != plain


def test_filtering_db_cli_bytes_match_jax(setup, tmp_path):
    reads = setup["reads"]
    (tmp_path / "q.fa").write_text("".join(
        f">{n}\n{s}\n" for n, _t, s in reads))
    setup["db"].save(tmp_path / "db")
    args = ["blastn", "-query", str(tmp_path / "q.fa"), "-db",
            str(tmp_path / "db"), "-outfmt", "6", "-filtering_db",
            setup["path"]]
    assert jax_main(args + ["-out", str(tmp_path / "jax.tsv")]) == 0
    assert torch_main(args + ["-out", str(tmp_path / "torch.tsv"),
                              "-device", "cpu"]) == 0
    assert torch_main(args[:-2] + ["-out", str(tmp_path / "plain.tsv"),
                                   "-device", "cpu"]) == 0
    want = (tmp_path / "jax.tsv").read_bytes()
    assert want.count(b"\n") >= 2
    assert (tmp_path / "torch.tsv").read_bytes() == want
    assert (tmp_path / "plain.tsv").read_bytes() != want


def test_plant_repeats_recipe():
    """chip_smoke.py's repeat genome (tools/workloads.py::plant_repeats):
    a tenth of the genome replaced by copies of the library's elements,
    one a slot, at 10-20% divergence on either strand, the first
    elements the most copied."""
    from gblastn_tpu_torch.tools.workloads import plant_repeats

    rng = np.random.default_rng(4)
    genome = _rand(rng, 300_000)
    elems, g2, copies = plant_repeats(rng, genome, n_elements=50)
    assert len(elems) == 50 and {len(e) for e in elems} == {300}
    assert len(g2) == len(genome) and len(copies) == 100
    starts = [c[0] for c in copies]
    assert all(b - a >= 300 for a, b in zip(starts, starts[1:]))
    assert {c[2] for c in copies} == {False, True}
    for st, e, minus in copies:
        got = _revcomp(g2[st: st + 300]) if minus else g2[st: st + 300]
        diff = sum(a != b for a, b in zip(got, elems[e]))
        assert 0.05 * 300 < diff < 0.26 * 300
    families = [c[1] for c in copies]
    assert families.count(0) > families.count(49)
    outside = np.ones(len(genome), bool)
    for st in starts:
        outside[st: st + 300] = False
    g_np = np.frombuffer(genome.encode(), np.uint8)
    g2_np = np.frombuffer(g2.encode(), np.uint8)
    assert np.array_equal(g_np[outside], g2_np[outside])
