"""The port's database masks (-db_soft_mask / -db_hard_mask) against
gblastn_tpu's, on tests/test_dbmask.py's shapes: a soft-masked range is
not seeded while extensions run through it, a hard mask renders the
masked bases as N, an unknown algorithm raises, and the CLI's mask flow
(makedb -mask_data, then blastn) gives the JAX package's bytes. Every HSP
field must match. Runs the port on the CPU (its plain PyTorch path)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu.cli.main import main as jax_main
from gblastn_tpu.engine.search import search as jax_search
from gblastn_tpu.io.fasta import FastaRecord as JaxRecord
from gblastn_tpu.io.seqdb import SequenceDB as JaxDB
from gblastn_tpu_torch.cli.main import main as torch_main
from gblastn_tpu_torch.engine.search import search as torch_search
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.params.options import megablast_options
from tests.test_torch_search import _jax_options, _rand, _rows

torch.set_num_threads(1)


def _genome(n=24000, seed=7):
    return _rand(np.random.default_rng(seed), n)


@pytest.fixture(scope="module")
def masked():
    """test_dbmask.py's database: one 24 kb subject with [8000, 9000)
    masked under algorithm 55, in each package."""
    g = _genome()
    dbs = []
    for cls, rec in ((SequenceDB, FastaRecord), (JaxDB, JaxRecord)):
        db = cls.from_records([rec("s1", "subject", g)], title="t")
        db.add_mask_set(55, "repeat", "test", {"s1": [(8000, 9000)]})
        dbs.append(db)
    return dict(genome=g, db=dbs[0], jdb=dbs[1])


def _search_both(m, reads, **kw):
    got = torch_search([FastaRecord(*r) for r in reads], m["db"],
                       megablast_options(**kw), device="cpu")
    want = jax_search([JaxRecord(*r) for r in reads], m["jdb"],
                      _jax_options("megablast", **kw))
    return _rows(got), _rows(want)


def test_soft_mask_suppresses_masked_hits(masked):
    g = masked["genome"]
    reads = [("q_in", "", g[8200:8500]), ("q_out", "", g[2000:2300])]
    plain, plain_want = _search_both(masked, reads, evalue=1e-3,
                                     dust=False)
    assert plain == plain_want and {r[0] for r in plain} == {0, 1}
    got, want = _search_both(masked, reads, evalue=1e-3, dust=False,
                             db_soft_mask=55)
    assert got == want
    assert {r[0] for r in got} == {1}, "a masked range must not be seeded"


def test_soft_mask_extension_crosses_boundary(masked):
    g = masked["genome"]
    got, want = _search_both(masked, [("q_span", "", g[7700:8200])],
                             evalue=1e-3, dust=False, db_soft_mask=55)
    assert got == want and got
    best = max((dict(r[3]) for r in got), key=lambda h: h["score"])
    assert best["s_end"] - best["s_off"] >= 450


def test_hard_mask_renders_n(masked):
    g = masked["genome"]
    dbs = []
    for cls, rec in ((SequenceDB, FastaRecord), (JaxDB, JaxRecord)):
        db = cls.from_records([rec("s1", "subject", _genome())], title="t")
        db.add_mask_set(55, "repeat", "test", {"s1": [(100, 200)]})
        db.apply_hard_mask(55)
        dbs.append(db)
    seq = dbs[0].get_sequence_blastna(0)
    np.testing.assert_array_equal(seq, dbs[1].get_sequence_blastna(0))
    assert (seq[100:200] == 14).all() and (seq[:100] != 14).all()
    # a search with the hard mask: its seeds and its scores
    m = {"db": SequenceDB.from_records(
        [FastaRecord("s1", "subject", g)], title="t"),
        "jdb": JaxDB.from_records([JaxRecord("s1", "subject", g)],
                                  title="t")}
    for db in (m["db"], m["jdb"]):
        db.add_mask_set(55, "repeat", "test", {"s1": [(8000, 9000)]})
    got, want = _search_both(m, [("q_span", "", g[7700:8200]),
                                 ("q_out", "", g[2000:2300])],
                             evalue=1e-3, dust=False, db_hard_mask=55)
    assert got == want and {r[0] for r in got} == {0, 1}
    assert m["db"].hard_mask_algo == 55


def test_unknown_algo_raises(masked):
    reads = [FastaRecord("q", "", masked["genome"][2000:2300])]
    with pytest.raises(KeyError):
        torch_search(reads, masked["db"], megablast_options(db_soft_mask=99),
                     device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        torch_search(reads, masked["db"], megablast_options(
            db_soft_mask=55, db_hard_mask=55), device="cpu")


def test_cli_mask_flow(tmp_path):
    """makedb -mask_data, then blastn with -db_soft_mask and with
    -db_hard_mask: each CLI's bytes equal the JAX package's; the read
    inside the mask finds nothing, the read across its edge aligns."""
    g = _genome(8000, seed=3)
    (tmp_path / "ref.fa").write_text(">s1\n" + g + "\n")
    (tmp_path / "m.intervals").write_text(">s1\n3000 - 3999\n")
    assert torch_main([
        "makedb", "-in", str(tmp_path / "ref.fa"), "-out",
        str(tmp_path / "db"), "-mask_data", str(tmp_path / "m.intervals"),
        "-mask_id", "40"]) == 0
    (tmp_path / "q.fa").write_text(
        f">q1\n{g[3200:3500]}\n>q2\n{g[2700:3100]}\n>q3\n{g[500:800]}\n")
    for flag in ([], ["-db_soft_mask", "40"], ["-db_hard_mask", "40"]):
        args = ["blastn", "-query", str(tmp_path / "q.fa"), "-db",
                str(tmp_path / "db"), "-outfmt", "6", "-dust", "no", *flag]
        assert jax_main(args + ["-out", str(tmp_path / "jax.tsv")]) == 0
        assert torch_main(args + ["-out", str(tmp_path / "torch.tsv"),
                                  "-device", "cpu"]) == 0
        want = (tmp_path / "jax.tsv").read_text()
        assert (tmp_path / "torch.tsv").read_text() == want
        names = {ln.split("\t")[0] for ln in want.splitlines()}
        assert names == ({"q1", "q2", "q3"} if not flag
                         else {"q2", "q3"}), (flag, names)
