"""The port's indexed megablast (-use_index, makembindex) against
gblastn_tpu's, on tests/test_dbindex.py's workload: the port's
``indexed_scan_block`` gives the JAX function's raw seeds in its lane
order and the port's own scan's seed set at the index's width; indexed
searches give the JAX package's HSPs at word 28 and word 11, plain and
with -db_soft_mask; and the CLI's makembindex plus -use_index gives its
bytes, its fallback warnings too. Runs the port on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu.cli.main import main as jax_main
from gblastn_tpu.engine.search import search as jax_search
from gblastn_tpu.io.fasta import FastaRecord as JaxRecord
from gblastn_tpu.io.seqdb import SequenceDB as JaxDB
from gblastn_tpu.lut.dbindex import build_db_index as jax_build_index
from gblastn_tpu_torch.cli.main import main as torch_main
from gblastn_tpu_torch.engine.search import search as torch_search
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.query import build_query_block
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.lut.builder import (
    build_lookup_table,
    unmasked_locations,
)
from gblastn_tpu_torch.lut.dbindex import build_db_index, save_db_index
from gblastn_tpu_torch.ops.seeding import indexed_scan_block, scan_block
from gblastn_tpu_torch.params.options import options_for_task
from tests.test_torch_search import _jax_options, _rand, _rows

torch.set_num_threads(1)

MASK = {"c1": [(1000, 3000)], "c2": [(1000, 4000)]}


def _reads(rng, genome, num, qlen, mut=0.02):
    out = []
    for i in range(num):
        s = int(rng.integers(0, len(genome) - qlen))
        read = list(genome[s: s + qlen])
        for p in np.flatnonzero(rng.random(qlen) < mut):
            read[p] = "ACGT"[("ACGT".index(read[p]) + 1
                              + int(rng.integers(0, 3))) % 4]
        out.append((f"r{i}", "", "".join(read)))
    return out


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """test_dbindex.py's: a 60 kb genome as two subjects saved once, with
    indexes at word 28 (LUT width 12) and word 11, and reads of it."""
    tmp = tmp_path_factory.mktemp("dbindex")
    rng = np.random.default_rng(31)
    genome = _rand(rng, 60000)
    SequenceDB.from_records(
        [FastaRecord("c1", "", genome[:40000]),
         FastaRecord("c2", "", genome[40000:])], title="idxdb",
    ).save(tmp / "db")
    db = SequenceDB.load(tmp / "db")
    save_db_index(build_db_index(db, 28, 12), str(tmp / "db"))
    save_db_index(build_db_index(db, 11), str(tmp / "db11"))
    return dict(tmp=tmp, genome=genome,
                reads=_reads(rng, genome, 12, 700),
                reads11=_reads(np.random.default_rng(5), genome, 6, 400,
                               mut=0.05))


def _dbs(tmp, mask=False):
    """Each package's database loaded afresh from ``tmp`` (so a cached
    index or device copy never carries over), with test_dbindex.py's
    mask column where ``mask``."""
    dbs = SequenceDB.load(tmp / "db"), JaxDB.load(tmp / "db")
    if mask:
        for db in dbs:
            db.add_mask_set(10, "dust", "test", MASK)
    return dbs


def test_raw_seed_set_equivalence(workload):
    """The indexed scan's seeds, in order, are the JAX function's
    compacted output, and as a set the port's own scan's at the index's
    width; with a mask, both drop the same seeds."""
    import jax.numpy as jnp

    from gblastn_tpu.ops.seeding import (
        indexed_scan_block as jax_indexed_scan_block,
    )

    db, _jdb = _dbs(workload["tmp"])
    index = build_db_index(db, 28, 12)
    qb = build_query_block([FastaRecord(*r) for r in workload["reads"]],
                           "both")
    locs = unmasked_locations(qb.buffer, qb.context_offsets())
    lut = build_lookup_table(qb.buffer, locs, 28, index.lut_word)
    qbuf = np.full(-(-len(qb.buffer) // 8) * 8, 15, np.uint8)
    qbuf[: len(qb.buffer)] = qb.buffer
    allowed = np.zeros(len(qbuf), bool)
    allowed[lut.positions] = True
    sub2 = torch.from_numpy(db.unpacked().astype(np.int8))
    valid = torch.from_numpy(db.valid_mask())
    db.add_mask_set(10, "dust", "test", MASK)
    ivs = db.mask_intervals(10)
    for mask in (None, (torch.from_numpy(ivs[:, 0].copy()),
                        torch.from_numpy(ivs[:, 1].copy()))):
        ms, me = mask if mask else (None, None)
        q_i, s_i = indexed_scan_block(
            torch.from_numpy(qbuf), torch.from_numpy(allowed),
            torch.from_numpy(index.offsets()),
            torch.from_numpy(index.positions), lut_word=index.lut_word,
            mask_starts=ms, mask_ends=me)
        n_scan = (sub2.shape[0] - lut.lut_word_size) // lut.scan_step + 1
        q_s, s_s = scan_block(
            sub2, valid, torch.from_numpy(lut.counts_offsets),
            torch.from_numpy(lut.positions), scan_step=lut.scan_step,
            lut_word=lut.lut_word_size, n_scan=n_scan, mask_starts=ms,
            mask_ends=me, chunk=257)
        got = list(zip(q_i.tolist(), s_i.tolist()))
        assert got and set(got) == set(zip(q_s.tolist(), s_s.tolist()))
        jq, js, jt, _drop, _n = jax_indexed_scan_block(
            jnp.asarray(qbuf), jnp.asarray(allowed),
            jnp.asarray(index.offsets()), jnp.asarray(index.positions),
            lut_word=index.lut_word, cmax=max(index.max_chain, 4),
            n_scan=len(qbuf) - index.lut_word + 1, hit_cap=0,
            mask_starts=None if mask is None else jnp.asarray(ivs[:, 0]),
            mask_ends=None if mask is None else jnp.asarray(ivs[:, 1]))
        jt = np.asarray(jt)
        assert got == list(zip(np.asarray(jq)[jt].tolist(),
                               np.asarray(js)[jt].tolist()))


@pytest.mark.parametrize("word,mask", [(28, False), (28, True),
                                       (11, False), (11, True)])
def test_search_indexed_equals_jax(workload, word, mask):
    """An indexed search (a second batch too, the cached index reused)
    gives the JAX package's HSPs and the port's own scan's at the index's
    width."""
    tmp = workload["tmp"]
    db, jdb = _dbs(tmp, mask)
    task = "megablast" if word == 28 else "blastn"
    reads = workload["reads"] if word == 28 else workload["reads11"]
    kw = dict(evalue=1e-5 if word == 28 else 1e-3, max_target_seqs=20,
              lut_word_size=12 if word == 28 else 11, use_index=True)
    if word == 11:
        kw["index_name"] = str(tmp / "db11")
    if mask:
        kw["db_soft_mask"] = 10
    opts = _jax_options(task, **kw)
    scan_kw = dict(kw, use_index=False)
    for batch in (reads, reads[:4]):
        got = _rows(torch_search([FastaRecord(*r) for r in batch], db,
                                 options_for_task(task, **kw), device="cpu"))
        want = _rows(jax_search([JaxRecord(*r) for r in batch], jdb, opts))
        scanned = _rows(torch_search([FastaRecord(*r) for r in batch], db,
                                     options_for_task(task, **scan_kw),
                                     device="cpu"))
        assert got == want == scanned and len(got) >= len(batch) // 2
    from gblastn_tpu_torch.lut.dbindex import DbIndex

    assert isinstance(db._db_index_cache, DbIndex)     # no fallback


def test_cli_makembindex_and_use_index(tmp_path, capsys):
    """makembindex then blastn -use_index true through each CLI: the
    same bytes; the port's index file equals the JAX package's; a
    missing index and a wrong word size warn as the JAX package warns
    and scan."""
    rng = np.random.default_rng(77)
    genome = _rand(rng, 30000)
    (tmp_path / "ref.fa").write_text(f">chrA test\n{genome}\n")
    (tmp_path / "q.fa").write_text(
        f">probe\n{genome[8000:8500]}\n>probe2\n{genome[21000:21700]}\n")
    assert torch_main(["makedb", "-in", str(tmp_path / "ref.fa"),
                       "-out", str(tmp_path / "db"), "-title", "t"]) == 0
    assert torch_main(["makembindex", "-input", str(tmp_path / "db")]) == 0
    assert "Built index" in capsys.readouterr().err
    with np.load(str(tmp_path / "db") + ".tix.npz") as z:
        got = {k: z[k] for k in z.files}
    want = jax_build_index(JaxDB.load(tmp_path / "db"), 28)
    np.testing.assert_array_equal(got["positions"], want.positions)
    np.testing.assert_array_equal(got["words"], want.words)
    base = ["blastn", "-query", str(tmp_path / "q.fa"), "-db",
            str(tmp_path / "db"), "-outfmt", "6"]
    for extra in (["-use_index", "true"],
                  ["-use_index", "true", "-index_name",
                   str(tmp_path / "nonexistent")],
                  ["-use_index", "true", "-word_size", "24"],
                  []):
        assert jax_main(base + extra + ["-out",
                                        str(tmp_path / "jax.tsv")]) == 0
        jerr = capsys.readouterr().err
        assert torch_main(base + extra + ["-out", str(tmp_path / "t.tsv"),
                                          "-device", "cpu"]) == 0
        terr = capsys.readouterr().err
        want = (tmp_path / "jax.tsv").read_text()
        assert (tmp_path / "t.tsv").read_text() == want
        assert want.startswith("probe\tchrA\t100.00\t500")
        warned = [ln for ln in jerr.splitlines() if "-use_index" in ln]
        assert warned == [ln for ln in terr.splitlines()
                          if "-use_index" in ln]
        assert bool(warned) == (len(extra) > 2), (extra, jerr)
