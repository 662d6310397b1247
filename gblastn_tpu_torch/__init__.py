"""gblastn_tpu_torch: the PyTorch / CUDA port of gblastn_tpu.

The same megablast search as ``gblastn_tpu`` (same options, same HSPs,
same output bytes), with the device path written in PyTorch and the
ungapped X-drop kernel written in CUDA C++ for Hopper (sm_90a). Host
stages (query setup, lookup table, greedy gapped extension, traceback,
formatting) are reused from ``gblastn_tpu`` unchanged; this package
imports ``torch`` and never ``jax``.

Public API:

    from gblastn_tpu_torch import SequenceDB, search, megablast_options

    db = SequenceDB.from_fasta("genome.fa")
    results = search(queries, db, megablast_options(), device="cuda")

``FastaRecord`` (a query) and ``slog`` (the stage timer behind
``-logfile``) are exported too.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy imports keep `import gblastn_tpu_torch` light (no torch init)
    if name in ("search", "prelim_search", "finish_search",
                "BlastResults"):
        from gblastn_tpu_torch.engine import search as _s

        return getattr(_s, name)
    # host types and the stage logger are gblastn_tpu's own, reused
    if name == "SequenceDB":
        from gblastn_tpu.io.seqdb import SequenceDB

        return SequenceDB
    if name == "FastaRecord":
        from gblastn_tpu.io.fasta import FastaRecord

        return FastaRecord
    if name in ("SearchOptions", "megablast_options", "options_for_task"):
        from gblastn_tpu.params import options as _o

        return getattr(_o, name)
    if name == "slog":
        from gblastn_tpu.utils.profiling import slog

        return slog
    raise AttributeError(
        f"module 'gblastn_tpu_torch' has no attribute {name!r}"
    )
