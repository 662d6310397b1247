"""The port's query splitting against gblastn_tpu's (tests/test_split.py's
shape, CHUNK_SIZE=5000): queries longer than the chunk are searched in
overlapping chunks and stitched at the prelim stage. Every HSP field of
the port's ``search()`` equals the JAX package's, and so do the -outfmt 6
bytes of the two CLIs, for megablast and blastn, on both strands, in a
batch that mixes split and unsplit queries. Runs the port on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu.cli.main import main as jax_main
from gblastn_tpu.engine.search import search as jax_search
from gblastn_tpu_torch.cli.main import main as torch_main
from gblastn_tpu_torch.engine.search import search as torch_search
from gblastn_tpu_torch.engine.split import split_records
from gblastn_tpu_torch.params.options import options_for_task
from tests.test_torch_search import (
    BASES,
    _both,
    _jax_options,
    _rand,
    _revcomp,
    _rows,
)

torch.set_num_threads(1)

CHUNK = 5000


def mosaic(rng, genome, length, seg=500, head=250):
    """A query of ``length`` bases made of ``seg``-base pieces of
    ``genome`` from random places and strands with 2% substitutions,
    the first piece ``head`` bases long (so a chunk boundary falls inside
    a piece); returns it and the pieces' (query start, genome start,
    minus) triples."""
    out, pieces, q = [], [], 0
    while q < length:
        n = min(head if q == 0 else seg, length - q)
        st = int(rng.integers(0, len(genome) - n))
        piece = list(genome[st: st + n])
        for p in np.flatnonzero(rng.random(n) < 0.02):
            piece[p] = BASES[(BASES.index(piece[p]) + 1) % 4]
        minus = bool(rng.integers(0, 2))
        piece = "".join(piece)
        out.append(_revcomp(piece) if minus else piece)
        pieces.append((q, st, minus))
        q += n
    return "".join(out), pieces


@pytest.fixture(scope="module")
def workload():
    """A 30 kb genome; in one batch a 12 kb query and a 9 kb query
    (three and two chunks), each a mosaic of 500-base pieces of the
    genome from both strands, and two 400-base reads (unsplit), one of
    them reverse-complemented."""
    rng = np.random.default_rng(606)
    genome = _rand(rng, 30000)
    long1, _ = mosaic(rng, genome, 12000)
    long2, _ = mosaic(rng, genome, 9000)
    reads = [
        ("long1", "", long1),
        ("short1", "", genome[1000:1400]),
        ("long2", "", long2),
        ("short2", "", _revcomp(genome[25000:25400])),
    ]
    return _both([("g", "split genome", genome)], reads, "splitdb")


def test_the_batch_mixes_split_and_unsplit(workload):
    _recs, info, any_split = split_records(workload["reads"], CHUNK, 100)
    assert any_split
    chunks = [sum(1 for i in info if i.orig_index == q) for q in range(4)]
    assert chunks == [3, 1, 2, 1]
    assert [len(r.sequence) for r in _recs] == [5000, 5000, 2200, 400,
                                                5000, 4100, 400]


@pytest.mark.parametrize("task", ["megablast", "blastn"])
def test_split_search_matches_jax(workload, monkeypatch, task):
    monkeypatch.setenv("CHUNK_SIZE", str(CHUNK))
    w = workload
    want = _rows(jax_search(w["jreads"], w["jdb"],
                            _jax_options(task, evalue=1e-6)))
    got = _rows(torch_search(w["reads"], w["db"],
                             options_for_task(task, evalue=1e-6),
                             device="cpu"))
    assert got == want
    assert {r[0] for r in got} == {0, 1, 2, 3}
    hsps = [(r[0], dict(r[3])) for r in got]
    assert {h["q_frame"] for _q, h in hsps} == {1, -1}
    # the piece across the first chunk boundary (query bases 4750-5250 of
    # both long queries) is one HSP, merged from its two chunks
    for qi in (0, 2):
        plus = [(h["q_off"], h["q_end"]) if h["q_frame"] > 0 else
                (len(w["reads"][qi].sequence) - h["q_end"],
                 len(w["reads"][qi].sequence) - h["q_off"])
                for q, h in hsps if q == qi]
        assert any(a <= CHUNK - 150 and b >= CHUNK + 150
                   for a, b in plus), plus


@pytest.mark.parametrize("task", ["megablast", "blastn"])
def test_split_cli_outfmt6_bytes_match_jax(workload, tmp_path, monkeypatch,
                                           task):
    monkeypatch.setenv("CHUNK_SIZE", str(CHUNK))
    w = workload
    (tmp_path / "q.fa").write_text("".join(
        f">{r.seq_id}\n{r.sequence}\n" for r in w["reads"]))
    w["db"].save(tmp_path / "db")
    args = ["blastn", "-task", task, "-query", str(tmp_path / "q.fa"),
            "-db", str(tmp_path / "db"), "-outfmt", "6", "-evalue", "1e-6"]
    assert jax_main(args + ["-out", str(tmp_path / "jax.tsv")]) == 0
    assert torch_main(args + ["-out", str(tmp_path / "torch.tsv"),
                              "-device", "cpu"]) == 0
    want = (tmp_path / "jax.tsv").read_bytes()
    assert {ln.split(b"\t")[0] for ln in want.splitlines()} == {
        b"long1", b"short1", b"long2", b"short2"}
    assert (tmp_path / "torch.tsv").read_bytes() == want


def test_strain_query_recipe():
    """chip_smoke.py's split query (tools/workloads.py::strain_query): a
    half segment first, then whole ones, each its locus on its strand
    with about 2% substitutions, so the chunk boundaries at multiples of
    the segment length fall inside a segment."""
    from gblastn_tpu_torch.tools.workloads import strain_query

    rng = np.random.default_rng(3)
    genome = _rand(rng, 50_000)
    seq, pieces = strain_query(rng, genome, 45_000, seg=4_000)
    assert len(seq) == 45_000
    assert [p[2] for p in pieces] == [2_000] + [4_000] * 10 + [3_000]
    assert {p[3] for p in pieces} == {False, True}
    for q0, st, n, minus in pieces:
        src = genome[st: st + n]
        got = _revcomp(seq[q0: q0 + n]) if minus else seq[q0: q0 + n]
        diff = sum(a != b for a, b in zip(got, src))
        assert 0 < diff < 0.04 * n
