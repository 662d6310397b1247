"""Discontiguous megablast, two-hit seeding, blastn-short and vecscreen in
the port against gblastn_tpu on the CPU: the discontiguous scan against the
JAX package's ``scan_block(disc_offsets=...)`` for every template, and
``search()`` and the CLI against the JAX package's on small planted
workloads (the shapes of tests/test_disc.py::TestDiscEngine and
tests/test_two_hit.py). Every HSP field must match; the -outfmt 6 bytes of
the two CLIs must be identical."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gblastn_tpu.cli.main import main as jax_main
from gblastn_tpu.engine.search import search as jax_search
from gblastn_tpu.io.fasta import FastaRecord as JaxRecord
from gblastn_tpu.io.seqdb import SequenceDB as JaxDB
from gblastn_tpu.lut.builder import (
    build_disc_lookup_table as jax_disc_lut,
)
from gblastn_tpu.ops.seeding import scan_block as jax_scan_block
from gblastn_tpu.params import options as jax_options
from gblastn_tpu_torch import FastaRecord, SequenceDB
from gblastn_tpu_torch.cli.main import main as torch_main
from gblastn_tpu_torch.engine.resident import resident_from_reference
from gblastn_tpu_torch.engine.search import search as torch_search
from gblastn_tpu_torch.lut.builder import build_disc_lookup_table
from gblastn_tpu_torch.lut.templates import DISC_TEMPLATES
from gblastn_tpu_torch.ops.seeding import scan_block, scan_span
from gblastn_tpu_torch.params.options import options_for_task

# the plain versions run many small ops: on the CPU one thread beats a pool
torch.set_num_threads(1)

BASES = "ACGT"


def _rand(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def _wobble(rng, seq, rate=0.3):
    """Third-position substitutions, as tests/test_disc.py makes them."""
    s = list(seq)
    for p in range(2, len(s), 3):
        if rng.random() < rate:
            s[p] = BASES[(BASES.index(s[p]) + 1 + int(rng.integers(0, 3)))
                         % 4]
    return "".join(s)


def _revcomp(s):
    return s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))


@pytest.mark.parametrize("key", sorted(DISC_TEMPLATES), ids=lambda k:
                         f"{k[0]}-{k[1]}-{k[2]}")
def test_disc_scan_matches_jax(key):
    """The port's scan_block with a discontiguous template resolves the
    JAX package's seeds, in its order, over two subjects (the words that
    reach a pad are not seeded) and a query with planted copies and an N;
    the two packages' tables are equal."""
    weight, length, kind = key
    rng = np.random.default_rng(300 + weight + length)
    g1, g2 = _rand(rng, 9000), _rand(rng, 5000)
    db = SequenceDB.from_records([FastaRecord("a", "", g1),
                                  FastaRecord("b", "", g2)])
    q = list(_rand(rng, 1500) + g1[2000:2600] + g2[4700:5000])
    q[1800] = "N"
    buf = np.array([15] + ["ACGT".index(c) if c != "N" else 14 for c in q]
                   + [15], np.uint8)
    locs = [(1, len(buf) - 2)]
    lut = build_disc_lookup_table(buf, locs, weight, length, kind)
    jlut = jax_disc_lut(buf, locs, weight, length, kind)
    np.testing.assert_array_equal(lut.counts_offsets, jlut.counts_offsets)
    np.testing.assert_array_equal(lut.positions, jlut.positions)
    assert lut.disc_offsets == jlut.disc_offsets == DISC_TEMPLATES[key]
    res = resident_from_reference(db, torch.device("cpu"))
    span = scan_span(lut.lut_word_size, lut.disc_offsets)
    n_scan = res.length - span + 1
    got_q, got_s = scan_block(
        res.subject2, res.valid, torch.from_numpy(lut.counts_offsets),
        torch.from_numpy(lut.positions), scan_step=1,
        lut_word=lut.lut_word_size, n_scan=n_scan,
        disc_offsets=lut.disc_offsets)
    jq, js, ok, n_drop, _n_hit = jax_scan_block(
        jnp.asarray(res.subject2.numpy()), jnp.asarray(res.valid.numpy()),
        jnp.asarray(lut.counts_offsets), jnp.asarray(lut.positions),
        scan_step=1, lut_word=lut.lut_word_size, word_size=length,
        cmax=max(lut.max_positions_per_word, 1), n_scan=n_scan,
        disc_offsets=lut.disc_offsets)
    assert int(n_drop) == 0
    ok = np.asarray(ok)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(jq)[ok])
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(js)[ok])
    assert len(got_q) > 800                    # the planted copies seed


def _jax_opts(task, **kw):
    return jax_options.options_for_task(task, **kw)


def _rows(res):
    """(query, oid, best e-value, every HSP field) in result order."""
    def fields(h):
        return tuple((k, list(v) if k == "edit_script" and v is not None
                      else v) for k, v in vars(h).items())

    return [(q.query_index, lst.oid, lst.best_evalue, fields(h))
            for q in res.queries for lst in q.hsplists for h in lst.hsps]


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(31)
    return "".join(BASES[i] for i in rng.integers(0, 4, 30000))


@pytest.fixture(scope="module")
def dbs(genome):
    return (JaxDB.from_records([JaxRecord("chr", "", genome)], title="t"),
            SequenceDB.from_records([FastaRecord("chr", "", genome)],
                                    title="t"))


def _search_both(dbs, reads, task, **kw):
    jdb, db = dbs
    want = jax_search([JaxRecord(*r) for r in reads], jdb,
                      _jax_opts(task, **kw))
    got = torch_search([FastaRecord(*r) for r in reads], db,
                       options_for_task(task, **kw), device="cpu")
    return _rows(got), _rows(want)


@pytest.mark.parametrize("tt,length", [
    ("coding", 18), ("optimal", 16), ("coding_and_optimal", 21)])
def test_dc_megablast_search_matches_jax(genome, dbs, tt, length):
    """dc-megablast on wobbled reads (plus and minus strand, an N, a read
    of random bases): every HSP equal to the JAX package's, and the
    diverged reads found."""
    rng = np.random.default_rng(41)
    reads = [("w1", "", _wobble(rng, genome[8000:8400])),
             ("w2", "", _revcomp(_wobble(rng, genome[15000:15500]))),
             ("n", "", _wobble(rng, genome[21000:21300])[:150] + "N"
              + _wobble(rng, genome[21151:21300])),
             ("noise", "", _rand(rng, 200))]
    got, want = _search_both(dbs, reads, "dc-megablast", evalue=1e-5,
                             template_type=tt, template_length=length)
    assert got == want
    assert {r[0] for r in got} >= {0, 1}


@pytest.mark.parametrize("window", [0, 40])
def test_blastn_window_search_matches_jax(dbs, genome, window):
    """blastn with window_size 0 and 40 (tests/test_two_hit.py's shape):
    a 300-base exact read (double words), a read with a substitution every
    ~8 bases (isolated single words), a 3%-substituted read."""
    rng = np.random.default_rng(17)
    sparse = list(genome[3000:3300])
    for p in range(5, 300, 8):
        sparse[p] = BASES[(BASES.index(sparse[p]) + 1) % 4]
    sub3 = list(genome[11000:11600])
    for p in np.flatnonzero(rng.random(600) < 0.03):
        sub3[p] = BASES[(BASES.index(sub3[p]) + 2) % 4]
    reads = [("exact", "", genome[4000:4300]),
             ("sparse", "", "".join(sparse)),
             ("sub3", "", _revcomp("".join(sub3)))]
    got, want = _search_both(dbs, reads, "blastn", dust=False,
                             window_size=window)
    assert got == want
    assert got and got[0][3] and dict(got[0][3])["num_ident"] == 300


@pytest.mark.parametrize("task,kw", [
    ("megablast", dict(window_size=40, evalue=1e-5)),
    ("blastn-short", dict()),
    ("vecscreen", dict()),
], ids=["megablast-window40", "blastn-short", "vecscreen"])
def test_other_tasks_match_jax(dbs, genome, task, kw):
    """megablast with two-hit seeding, blastn-short on short reads and
    vecscreen: every HSP equal to the JAX package's."""
    rng = np.random.default_rng(23)
    if task == "blastn-short":
        reads = [(f"s{k}", "", genome[st: st + 32]) for k, st in
                 enumerate((1000, 7000, 19000))]
        reads.append(("sm", "", _revcomp(genome[25000:25030])))
    else:
        sub = list(genome[9000:9800])
        for p in np.flatnonzero(rng.random(800) < 0.04):
            sub[p] = BASES[(BASES.index(sub[p]) + 1) % 4]
        reads = [("sub", "", "".join(sub)),
                 ("minus", "", _revcomp(genome[14000:14500])),
                 ("noise", "", _rand(rng, 300))]
    got, want = _search_both(dbs, reads, task, **kw)
    assert got == want
    assert got


def test_dc_megablast_cli_bytes_match_jax(genome, tmp_path):
    """-task dc-megablast -template_length 21 -template_type optimal
    -outfmt 6: the port's bytes (-device cpu) equal the JAX CLI's; the
    template flags without -task dc-megablast are refused by both."""
    rng = np.random.default_rng(43)
    q = tmp_path / "q.fa"
    q.write_text(">d1\n" + _wobble(rng, genome[5000:5400]) + "\n>d2\n"
                 + _revcomp(_wobble(rng, genome[26000:26600])) + "\n")
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr1 c\n" + genome + "\n")
    assert torch_main(["makedb", "-in", str(ref), "-out",
                       str(tmp_path / "db"), "-title", "t"]) == 0
    args = ["blastn", "-query", str(q), "-db", str(tmp_path / "db"),
            "-task", "dc-megablast", "-template_length", "21",
            "-template_type", "optimal", "-outfmt", "6"]
    assert jax_main(args + ["-out", str(tmp_path / "jax.tsv")]) == 0
    assert torch_main(args + ["-out", str(tmp_path / "torch.tsv"),
                              "-device", "cpu"]) == 0
    want = (tmp_path / "jax.tsv").read_bytes()
    assert want.count(b"\n") >= 2
    assert (tmp_path / "torch.tsv").read_bytes() == want
    with pytest.raises(SystemExit):
        torch_main(["blastn", "-query", str(q), "-db", str(tmp_path / "db"),
                    "-task", "megablast", "-template_length", "18",
                    "-device", "cpu"])
