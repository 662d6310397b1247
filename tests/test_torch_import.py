"""gblastn_tpu_torch imports and searches with ``jax``, ``gblastn_tpu``
and ``bench`` blocked, and asking for a CUDA device without a card raises
instead of falling back."""
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
import os
import sys
for name in ("jax", "gblastn_tpu", "bench"):
    sys.modules[name] = None       # any import of them now raises
import numpy as np
import torch

import gblastn_tpu_torch
from gblastn_tpu_torch.cli.main import main

rng = np.random.default_rng(5)
genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 8000))
FastaRecord = gblastn_tpu_torch.FastaRecord
db = gblastn_tpu_torch.SequenceDB.from_records([FastaRecord("g", "", genome)])
reads = [FastaRecord("a", "", genome[1000:1300]),
         FastaRecord("b", "", genome[5000:5250])]
for options in (gblastn_tpu_torch.megablast_options(),
                gblastn_tpu_torch.blastn_options()):
    # blastn also runs the plain version of the device gapped filter
    os.environ["GBLASTN_TPU_GAPPED_FILTER"] = (
        "1" if options.task.value == "blastn" else "auto")
    res = gblastn_tpu_torch.search(reads, db, options, device="cpu")
    spans = [(q.query_index, l.hsps[0].s_off, l.hsps[0].s_end)
             for q in res.queries for l in q.hsplists]
    assert spans == [(0, 1000, 1300), (1, 5000, 5250)], spans

if torch.cuda.is_available():
    print("CUDA-PRESENT")
else:
    from gblastn_tpu_torch.device import resolve_device
    for call in (lambda: resolve_device("cuda"),
                 lambda: gblastn_tpu_torch.search(
                     reads, db, gblastn_tpu_torch.megablast_options()),
                 lambda: main(["blastn", "-query", "q.fa", "-db", "d",
                               "-device", "cuda"])):
        try:
            call()
        except RuntimeError as e:
            assert "is_available" in str(e), e
        else:
            raise SystemExit("cuda without a card did not raise")
for name in ("jax", "gblastn_tpu", "bench"):
    assert sys.modules[name] is None, name
    assert not [m for m in sys.modules if m.startswith(name + ".")], name
print("PORT-OK")
"""

# an import of the JAX package or of bench.py, in any form
_FORBIDDEN = re.compile(
    r"\bgblastn_tpu\.\w|\bfrom gblastn_tpu\s|\bimport gblastn_tpu\b(?!_)"
    r"|\bimport bench\b|\bfrom bench\s|^\s*(import|from) jax\b"
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
    """chip_smoke.py's own copies of bench.py's genome and read recipe
    give bench.py's genome and reads (config 1: the first 500-read set
    after the genome; config 2: the blastn reads from seed + 2), here on
    a shorter genome and fewer reads."""
    import bench
    import chip_smoke

    seed = chip_smoke.SEED
    assert seed == bench.SEED
    num, qlen, prefix = ((20, chip_smoke.QUERY_LEN, "w0_") if config == 1
                         else (12, chip_smoke.C2_QUERY_LEN, "b"))
    assert qlen == (bench.QUERY_LEN if config == 1 else 1500)
    rng_g, rng_w = np.random.default_rng(seed), np.random.default_rng(seed)
    genome = chip_smoke.make_genome(rng_g, 60_000)
    assert genome == bench._make_genome(rng_w, 60_000)
    if config == 2:
        rng_g = np.random.default_rng(seed + 2)
        rng_w = np.random.default_rng(seed + 2)
    pairs, starts = chip_smoke.sample_reads(rng_g, genome, num, qlen, prefix)
    want = bench._sample_reads(rng_w, genome, num, qlen, prefix)
    assert pairs == [(r.seq_id, r.sequence) for r in want]
    assert rng_g.random() == rng_w.random()        # same draws consumed
    for (_name, seq), st in zip(pairs, starts):
        # any deletion lies past base 100: the head is the source, 2% off
        assert sum(a != b for a, b in zip(seq[:100], genome[st:])) < 15


def test_sources_never_import_jax():
    files = list((REPO / "gblastn_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 50
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            assert not _FORBIDDEN.search(line), f"{f}:{n}: {line.strip()}"
    for bad in ("import jax", "from gblastn_tpu.io import fasta",
                "x = gblastn_tpu.hits", "import gblastn_tpu",
                "    import bench", "from bench import _sample_reads"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import gblastn_tpu_torch", "from gblastn_tpu_torch.io "
               "import fasta", "see gblastn_tpu/ops/pallas_gapped.py"):
        assert not _FORBIDDEN.search(ok), ok
