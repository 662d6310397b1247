"""Pipelined batch execution (-mode 0/2): overlap device seeding with host
stages.

The port of ``gblastn_tpu/engine/pipeline.py``, G-BLASTN's pipeline mode
(reference: NCBI c++/src/app/blast/blastn_app.cpp Method2 :725-989 and
Method3 :991-1261), with the same single-threaded interleave and the
same order:

* for batch k, ``prelim_search_steps`` runs query setup + LUT build and
  LAUNCHES the device seeding (scan, K1, the device finish), then
  suspends before its one wait, nothing fetched;
* while the card computes batch k, the caller runs the host finish
  stage (traceback + filtering + formatting callback) of batch k-2;
* resuming the generator of batch k-1 fetches its saved seeds and runs
  its host prelim stages.

Output order is submission order by construction, and an exception in
any stage propagates. Queries are searched whole: the generator form
does not split a query longer than the chunk, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from gblastn_tpu_torch.engine.search import (
    BlastResults,
    finish_search,
    prelim_search_steps,
)
from gblastn_tpu_torch.engine.seeding import drive
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.params.options import SearchOptions


def run_pipelined_search(
    batches: Iterable[list[FastaRecord]],
    db: SequenceDB,
    options: SearchOptions,
    on_results: Callable[[BlastResults], None],
    device: str | torch.device = "cuda",
    interrupt_fn=None,
) -> int:
    """Stream query batches through the interleaved pipeline on
    ``device``; calls ``on_results`` for every batch in submission
    order. Returns the number of batches processed. Exceptions in any
    stage propagate; ``interrupt_fn`` is polled at stage boundaries
    (utils.interrupt). The JAX package's ``trace_threads`` and
    ``queue_depth``, which it does not use, have no counterpart."""
    done = 0
    pending_gen = None      # batch k-1: launched, not yet fetched
    pending_finish = None   # batch k-2: prelim done, awaiting finish
    for batch in batches:
        gen = prelim_search_steps(batch, db, options, device, interrupt_fn)
        next(gen)          # setup + device launch for batch k
        if pending_finish is not None:
            # traceback/formatting of batch k-2 runs while the card
            # computes the k-1 and k seeding
            on_results(
                finish_search(pending_finish, db, options, interrupt_fn)
            )
            done += 1
        if pending_gen is not None:
            # fetch batch k-1 (its work is ahead of k in the stream, so
            # this rarely waits) + its host prelim stages
            pending_finish = drive(pending_gen)
        pending_gen = gen
    if pending_finish is not None:
        on_results(
            finish_search(pending_finish, db, options, interrupt_fn)
        )
        done += 1
    if pending_gen is not None:
        prelim = drive(pending_gen)
        on_results(finish_search(prelim, db, options, interrupt_fn))
        done += 1
    return done
