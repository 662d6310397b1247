"""The port's search and CLI against gblastn_tpu's on planted workloads.

Both packages run on one ``SequenceDB`` object (the port caches its
device state under its own attribute). Every HSP field, e-value and bit
score included, must match; the -outfmt 6 bytes of the two CLIs must be
identical. Runs the port on the CPU (its plain PyTorch path)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu.cli.main import main as jax_main
from gblastn_tpu.engine.search import search as jax_search
from gblastn_tpu.io.fasta import FastaRecord
from gblastn_tpu.io.seqdb import SequenceDB
from gblastn_tpu.ops.seeding import subject_arrays_from_packed
from gblastn_tpu.params.options import ExtensionMethod, megablast_options
from gblastn_tpu_torch.cli.main import main as torch_main
from gblastn_tpu_torch.engine.resident import resident_from_reference
from gblastn_tpu_torch.engine.search import search as torch_search

BASES = "ACGT"


def _rand(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def _revcomp(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    return "".join(comp[c] for c in reversed(s))


@pytest.fixture(scope="module")
def workload():
    """tests/test_search_e2e.py's planted reads over two subjects: plus
    and minus strand, substitutions, a deletion, a read of subject 2, an
    N in a query, a dust-masked low-complexity prefix, no-hit noise."""
    rng = np.random.default_rng(42)
    g1, g2 = _rand(rng, 20000), _rand(rng, 12000)
    db = SequenceDB.from_records(
        [FastaRecord("chr1", "synthetic chromosome", g1),
         FastaRecord("chr2", "second subject", g2)], title="testdb",
    )
    subst = list(g1[1000:1400])
    for pos in (100, 200, 300):
        subst[pos] = BASES[(BASES.index(subst[pos]) + 1) % 4]
    with_n = list(g2[6000:6300])
    with_n[150] = "N"
    reads = [
        FastaRecord("plus", "exact plus", g1[5000:5200]),
        FastaRecord("minus", "", _revcomp(g1[8000:8150])),
        FastaRecord("subst", "", "".join(subst)),
        FastaRecord("del", "", g1[2000:2200] + g1[2204:2400]),
        FastaRecord("sub2", "", g2[3000:3300]),
        FastaRecord("withN", "", "".join(with_n)),
        FastaRecord("dusty", "", "AC" * 30 + g1[12000:12200]),
        FastaRecord("noise", "", _rand(rng, 80)),
    ]
    return db, reads


def _rows(res):
    return [
        (q.query_index, lst.oid, lst.best_evalue, h)
        for q in res.queries for lst in q.hsplists for h in lst.hsps
    ]


def test_resident_forms_match_jax(workload):
    db, _ = workload
    res = resident_from_reference(db, torch.device("cpu"))
    starts = np.asarray(db.starts)
    ends = starts + np.asarray(db.lengths)
    sub2, valid, sw = subject_arrays_from_packed(
        db.packed_padded(), starts, ends)
    np.testing.assert_array_equal(res.subject2.numpy(), np.asarray(sub2))
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(res.valid.numpy(), db.valid_mask())
    np.testing.assert_array_equal(res.subject_w.numpy(),
                                  np.asarray(sw).astype(np.int64))
    np.testing.assert_array_equal(res.packed.numpy(), db.packed_padded())
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
    db, reads = workload
    options = megablast_options(**opts)
    want = jax_search(reads, db, options)
    got = torch_search(reads, db, options, device="cpu")
    w, g = _rows(want), _rows(got)
    assert g == w
    hit = {q.query_index for q in got.queries if q.hsplists}
    assert 7 not in hit                          # noise finds nothing
    if not opts:
        assert hit == {0, 1, 2, 3, 4, 5, 6}      # every planted read
    else:
        assert hit


def test_cli_outfmt6_bytes_match_jax(workload, tmp_path):
    db, reads = workload
    (tmp_path / "q.fa").write_text("".join(
        f">{r.seq_id} {r.title}\n{r.sequence}\n" for r in reads))
    db.save(tmp_path / "db")
    args = ["blastn", "-query", str(tmp_path / "q.fa"), "-db",
            str(tmp_path / "db"), "-outfmt", "6"]
    assert jax_main(args + ["-out", str(tmp_path / "jax.tsv")]) == 0
    assert torch_main(args + ["-out", str(tmp_path / "torch.tsv"),
                              "-device", "cpu"]) == 0
    want = (tmp_path / "jax.tsv").read_bytes()
    assert want.count(b"\n") >= 7
    assert (tmp_path / "torch.tsv").read_bytes() == want


def test_outside_the_slice_refuses(workload):
    db, reads = workload
    for kw in (dict(window_size=40), dict(use_index=True),
               dict(db_soft_mask=10)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            torch_search(reads[:1], db, megablast_options(**kw),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        torch_main(["blastn", "-query", "q.fa", "-db", "db", "-mode", "2",
                    "-device", "cpu"])
