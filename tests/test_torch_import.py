"""gblastn_tpu_torch imports and searches (the off-diagonal replay, a
streamed and a sharded database among them) with ``jax``,
``gblastn_tpu``, ``bench`` and ``chip_smoke`` blocked, and asking for a
CUDA device without a card raises instead of falling back."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

_PROG = r"""
import importlib
import os
import sys
for name in ("jax", "gblastn_tpu", "bench", "chip_smoke"):
    sys.modules[name] = None       # any import of them now raises
import numpy as np
import torch

import gblastn_tpu_torch
from gblastn_tpu_torch.cli.main import main
for tool in ("prof_scan_parts", "prof_scan_rate", "prof_gapped", "prof_e2e"):
    importlib.import_module("gblastn_tpu_torch.tools." + tool)

rng = np.random.default_rng(5)
genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 8000))
FastaRecord = gblastn_tpu_torch.FastaRecord
db = gblastn_tpu_torch.SequenceDB.from_records([FastaRecord("g", "", genome)])
reads = [FastaRecord("a", "", genome[1000:1300]),
         FastaRecord("b", "", genome[5000:5250])]
for options in (gblastn_tpu_torch.megablast_options(),
                gblastn_tpu_torch.blastn_options(),
                gblastn_tpu_torch.options_for_task("dc-megablast"),
                gblastn_tpu_torch.megablast_options(window_size=40)):
    # blastn also runs the plain version of the device gapped filter
    os.environ["GBLASTN_TPU_GAPPED_FILTER"] = (
        "1" if options.task.value == "blastn" else "auto")
    res = gblastn_tpu_torch.search(reads, db, options, device="cpu")
    spans = [(q.query_index, l.hsps[0].s_off, l.hsps[0].s_end)
             for q in res.queries for l in q.hsplists]
    assert spans == [(0, 1000, 1300), (1, 5000, 5250)], spans

# two-hit seeding with -off_diagonal_range, and the database streamed in
# blocks (engine.stream)
res = gblastn_tpu_torch.search(
    reads, db, gblastn_tpu_torch.blastn_options(window_size=40,
                                                off_diagonal_range=4),
    device="cpu")
assert [(q.query_index, l.hsps[0].s_off) for q in res.queries
        for l in q.hsplists] == [(0, 1000), (1, 5000)]
os.environ.update(GBLASTN_TPU_STREAM="1", GBLASTN_TPU_BLOCK_BASES="2048",
                  GBLASTN_TPU_BLOCK_HALO="256")
sdb = gblastn_tpu_torch.SequenceDB.from_records([FastaRecord("g", "", genome)])
res = gblastn_tpu_torch.search(reads, sdb, gblastn_tpu_torch.blastn_options(),
                               device="cpu")
assert [(q.query_index, l.hsps[0].s_off, l.hsps[0].s_end)
        for q in res.queries for l in q.hsplists] == [(0, 1000, 1300),
                                                       (1, 5000, 5250)]
assert not hasattr(sdb, "_torch_resident")
for name in ("GBLASTN_TPU_STREAM", "GBLASTN_TPU_BLOCK_BASES",
             "GBLASTN_TPU_BLOCK_HALO"):
    del os.environ[name]

# the database sharded over three shards in one process (parallel.dist)
os.environ["GBLASTN_TPU_SHARDS"] = "3"
hdb = gblastn_tpu_torch.SequenceDB.from_records([FastaRecord("g", "", genome)])
res = gblastn_tpu_torch.search(reads, hdb, gblastn_tpu_torch.blastn_options(),
                               device="cpu")
assert [(q.query_index, l.hsps[0].s_off, l.hsps[0].s_end)
        for q in res.queries for l in q.hsplists] == [(0, 1000, 1300),
                                                       (1, 5000, 5250)]
assert hdb._torch_shards and not hasattr(hdb, "_torch_resident")
del os.environ["GBLASTN_TPU_SHARDS"]

# the pipelined mode and the repeat filter's module
from gblastn_tpu_torch.engine.pipeline import run_pipelined_search
from gblastn_tpu_torch.masking.repeats import find_repeat_masks
got = []
assert run_pipelined_search(iter([reads[:1], reads[1:]]), db,
                            gblastn_tpu_torch.megablast_options(),
                            got.append, device="cpu") == 2
assert [r.queries[0].hsplists[0].hsps[0].s_off for r in got] == [1000, 5000]
masks = find_repeat_masks(reads, db, device="cpu")
assert masks == [[(0, 299)], [(0, 249)]], masks

if torch.cuda.is_available():
    print("CUDA-PRESENT")
else:
    from gblastn_tpu_torch.device import resolve_device
    for call in (lambda: resolve_device("cuda"),
                 lambda: gblastn_tpu_torch.search(
                     reads, db, gblastn_tpu_torch.megablast_options()),
                 lambda: main(["blastn", "-query", "q.fa", "-db", "d",
                               "-device", "cuda"]),
                 lambda: main(["blastn", "-query", "q.fa", "-db", "d",
                               "-mode", "2"]),
                 lambda: run_pipelined_search(
                     iter([reads]), db,
                     gblastn_tpu_torch.megablast_options(), got.append),
                 lambda: find_repeat_masks(reads, db)):
        try:
            call()
        except RuntimeError as e:
            assert "is_available" in str(e), e
        else:
            raise SystemExit("cuda without a card did not raise")
for name in ("jax", "gblastn_tpu", "bench", "chip_smoke"):
    assert sys.modules[name] is None, name
    assert not [m for m in sys.modules if m.startswith(name + ".")], name
print("PORT-OK")
"""

# an import of the JAX package, of bench.py or of chip_smoke.py, in any
# form
_FORBIDDEN = re.compile(
    r"\bgblastn_tpu\.\w|\bfrom gblastn_tpu\s|\bimport gblastn_tpu\b(?!_)"
    r"|\bimport bench\b|\bfrom bench\s|^\s*(import|from) jax\b"
    r"|\bimport chip_smoke\b|\bfrom chip_smoke\s"
)


def test_port_runs_with_jax_blocked():
    r = subprocess.run(
        [sys.executable, "-c", _PROG], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PORT-OK" in r.stdout


@pytest.mark.parametrize("config", [1, 2])
def test_smoke_workload_matches_bench(config):
    """The port's copies of bench.py's genome and read recipe
    (gblastn_tpu_torch/tools/workloads.py, which chip_smoke.py and the
    profilers use) give bench.py's genome and reads (config 1: the first
    500-read set after the genome; config 2: the blastn reads from seed +
    2), here on a shorter genome and fewer reads."""
    import bench
    import chip_smoke
    from gblastn_tpu_torch.tools import workloads

    seed = chip_smoke.SEED
    assert seed == workloads.SEED == bench.SEED
    for name in ("GENOME_LEN", "NUM_QUERIES", "QUERY_LEN",
                 "BIG_GENOME_LEN"):
        assert getattr(workloads, name) == getattr(bench, name), name
    assert chip_smoke.make_genome is workloads.make_genome
    num, qlen, prefix = ((20, chip_smoke.QUERY_LEN, "w0_") if config == 1
                         else (12, chip_smoke.C2_QUERY_LEN, "b"))
    assert qlen == (bench.QUERY_LEN if config == 1 else 1500)
    rng_g, rng_w = np.random.default_rng(seed), np.random.default_rng(seed)
    genome = workloads.make_genome(rng_g, 60_000)
    assert genome == bench._make_genome(rng_w, 60_000)
    if config == 2:
        rng_g = np.random.default_rng(seed + 2)
        rng_w = np.random.default_rng(seed + 2)
    pairs, starts = workloads.sample_reads(rng_g, genome, num, qlen, prefix)
    want = bench._sample_reads(rng_w, genome, num, qlen, prefix)
    assert pairs == [(r.seq_id, r.sequence) for r in want]
    assert rng_g.random() == rng_w.random()        # same draws consumed
    for (_name, seq), st in zip(pairs, starts):
        # any deletion lies past base 100: the head is the source, 2% off
        assert sum(a != b for a, b in zip(seq[:100], genome[st:])) < 15


def test_config2d_workload_matches_bench(monkeypatch):
    """workloads.config2d_reads gives the reads that bench.py's
    bench_config2d searches (its draws and its wobble, from the
    generator it is given: here SEED + 6), on a shorter genome."""
    import bench
    import gblastn_tpu.engine.search as jes
    from gblastn_tpu_torch.tools import workloads

    seen = []

    class _Empty:
        queries = []

    def record(reads, db, options):
        seen.append([(r.seq_id, r.sequence) for r in reads])
        return _Empty()

    monkeypatch.setattr(jes, "search", record)
    genome = workloads.make_genome(np.random.default_rng(9), 60_000)
    bench.bench_config2d(None, genome,
                         np.random.default_rng(workloads.SEED + 6))
    got, starts = workloads.config2d_reads(genome)
    assert seen[0] == seen[1] == got
    assert len(got) == workloads.C2_QUERIES == 200
    assert all(len(s) in (1500, 1497) for _n, s in got)
    for (_name, seq), st in zip(got, starts):
        # wobble (about 8%) and 2% substitutions: the head is the source
        assert sum(a != b for a, b in zip(seq[:100], genome[st:])) < 30


def test_scan_rate_workload_matches_reference(monkeypatch):
    """workloads.make_workload gives tools/prof_scan_rate.py's genome and
    reads (the same draws in the same order), here on a shorter
    genome."""
    import importlib.util

    from gblastn_tpu_torch.tools import workloads

    spec = importlib.util.spec_from_file_location(
        "_ref_prof_scan_rate", REPO / "tools" / "prof_scan_rate.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert ref.GENOME == workloads.GENOME_LEN
    monkeypatch.setattr(ref, "GENOME", 40_000)
    want_db, want = ref.make_workload(seed=3, num_queries=6, qlen=700)
    db, got = workloads.make_workload(seed=3, num_queries=6, qlen=700,
                                      genome_len=40_000)
    assert [(r.seq_id, r.sequence) for r in got] == [
        (r.seq_id, r.sequence) for r in want]
    assert np.array_equal(db.packed, want_db.packed)
    assert list(db.lengths) == list(want_db.lengths)


def test_sources_never_import_jax():
    files = list((REPO / "gblastn_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 50
    # the profilers are scanned too
    assert REPO / "gblastn_tpu_torch" / "tools" / "prof_scan_parts.py" in files
    # and so are the pipelined mode, the repeat filter, the stream and
    # the sharding
    for mod in ("engine/pipeline.py", "masking/repeats.py",
                "engine/stream.py", "parallel/dist.py"):
        assert REPO / "gblastn_tpu_torch" / mod in files, mod
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            assert not _FORBIDDEN.search(line), f"{f}:{n}: {line.strip()}"
    for bad in ("import jax", "from gblastn_tpu.io import fasta",
                "x = gblastn_tpu.hits", "import gblastn_tpu",
                "    import bench", "from bench import _sample_reads",
                "import chip_smoke", "from chip_smoke import SEED"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import gblastn_tpu_torch", "from gblastn_tpu_torch.io "
               "import fasta", "see gblastn_tpu/ops/pallas_gapped.py"):
        assert not _FORBIDDEN.search(ok), ok
