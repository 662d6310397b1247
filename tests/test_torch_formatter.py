"""The port's blast_formatter against gblastn_tpu's
(tests/test_blast4.py::test_blast_formatter_roundtrip's shape): an
-outfmt 11 archive, written by the JAX package's CLI or by the port's,
re-rendered by the port as -outfmt 0, 6, 7 and 10 gives the JAX
package's blast_formatter bytes, and the archive's tabular forms equal a
direct run's (-outfmt 7 but for its "# Database:" line). Runs the port
on the CPU (blast_formatter itself is host-only)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu.cli.main import main as jax_main
from gblastn_tpu_torch.cli.main import main as torch_main

torch.set_num_threads(1)

FORMATS = ("0", "6", "7", "10")


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """A 20 kb genome as a database; two queries (a minus-strand one
    with a deletion, so the alignment is gapped, and a plus one); the
    -outfmt 11 archive of each CLI and the port's direct tabular runs."""
    d = tmp_path_factory.mktemp("formatter")
    rng = np.random.default_rng(81)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    frag = g[6000:6400]
    frag = frag[:150] + frag[153:]        # deletion -> gapped script
    rc = "".join(comp[c] for c in reversed(frag))
    (d / "ref.fa").write_text(">chr1 archive chrom\n" + g + "\n")
    (d / "q.fa").write_text(f">am\n{rc}\n>ap\n{g[11000:11350]}\n")
    assert torch_main(["makedb", "-in", str(d / "ref.fa"), "-out",
                       str(d / "db"), "-title", "archdb"]) == 0
    args = ["blastn", "-query", str(d / "q.fa"), "-db", str(d / "db")]
    assert jax_main(args + ["-outfmt", "11", "-out", str(d / "jax.11")]) == 0
    assert torch_main(args + ["-outfmt", "11", "-out", str(d / "torch.11"),
                              "-device", "cpu"]) == 0
    direct = {}
    for f in FORMATS[1:]:
        out = d / f"direct{f}.txt"
        assert torch_main(args + ["-outfmt", f, "-out", str(out),
                                  "-device", "cpu"]) == 0
        direct[f] = out.read_bytes()
    return d, direct


def _format(main, archive, fmt, out):
    assert main(["blast_formatter", "-archive", str(archive), "-outfmt",
                 fmt, "-out", str(out)]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_blast_formatter_matches_jax(archives, writer, fmt):
    d, direct = archives
    arc = d / f"{writer}.11"
    got = _format(torch_main, arc, fmt, d / f"{writer}_{fmt}_torch.txt")
    want = _format(jax_main, arc, fmt, d / f"{writer}_{fmt}_jax.txt")
    assert got == want
    assert got.count(b"\n") >= 2
    if fmt in direct:
        # -outfmt 7's "# Database:" line names the archived path where a
        # direct run names the database's title, in both packages
        assert _no_db_line(got) == _no_db_line(direct[fmt])
        assert (got == direct[fmt]) == (fmt != "7")


def _no_db_line(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith(b"# Database:")]
