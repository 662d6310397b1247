"""gblastn_tpu_torch imports and searches with ``jax`` blocked, and asking
for a CUDA device without a card raises instead of falling back."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROG = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
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
res = gblastn_tpu_torch.search(
    reads, db, gblastn_tpu_torch.megablast_options(), device="cpu")
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
assert [m for m in sys.modules if m == "jax" or m.startswith("jax.")] \
    == ["jax"] and sys.modules["jax"] is None
print("PORT-OK")
"""


def test_port_runs_with_jax_blocked():
    r = subprocess.run(
        [sys.executable, "-c", _PROG], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PORT-OK" in r.stdout


def test_sources_never_import_jax():
    files = list((REPO / "gblastn_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))), (f, s)
    # the smoke reaches the JAX package's host modules only via the port
    for line in (REPO / "chip_smoke.py").read_text().splitlines():
        s = line.strip()
        assert not s.startswith(("import gblastn_tpu ", "import gblastn_tpu.",
                                 "from gblastn_tpu ", "from gblastn_tpu.")), s
