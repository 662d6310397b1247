"""gblastn_tpu_torch: the PyTorch / CUDA port of gblastn_tpu.

The same megablast, blastn, blastn-short, vecscreen and dc-megablast
searches as ``gblastn_tpu``, one-hit or two-hit (same options, same HSPs,
same output bytes), with the device path written in PyTorch and its
kernels written in CUDA C++ for Hopper (sm_90a): the ungapped X-drop
(K1), the banded gapped DP (K2), and the seeding finish's double-word
probe (RR), approximate gate (G) and diagonal replay (R). The host stages
(query setup, lookup
table, gapped extension, traceback, formatting) are the port's own
copies of the JAX package's JAX-free modules, at the same relative
paths; this package imports ``torch`` and never ``jax`` or
``gblastn_tpu``. Its profilers (``gblastn_tpu_torch.tools``) add a
third CUDA kernel, the table gather of the scan profiler.

Public API:

    from gblastn_tpu_torch import SequenceDB, search, megablast_options

    db = SequenceDB.from_fasta("genome.fa")
    results = search(queries, db, megablast_options(), device="cuda")

``FastaRecord`` (a query), ``blastn_options``, ``options_for_task`` and
``slog`` (the stage timer behind ``-logfile``) are exported too.
"""

__version__ = "0.2.0"


def __getattr__(name):
    # lazy imports keep `import gblastn_tpu_torch` light (no torch init)
    if name in ("search", "prelim_search", "finish_search",
                "BlastResults"):
        from gblastn_tpu_torch.engine import search as _s

        return getattr(_s, name)
    if name == "SequenceDB":
        from gblastn_tpu_torch.io.seqdb import SequenceDB

        return SequenceDB
    if name == "FastaRecord":
        from gblastn_tpu_torch.io.fasta import FastaRecord

        return FastaRecord
    if name in ("SearchOptions", "megablast_options", "blastn_options",
                "options_for_task"):
        from gblastn_tpu_torch.params import options as _o

        return getattr(_o, name)
    if name == "slog":
        from gblastn_tpu_torch.utils.profiling import slog

        return slog
    raise AttributeError(
        f"module 'gblastn_tpu_torch' has no attribute {name!r}"
    )
