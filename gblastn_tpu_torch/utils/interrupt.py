"""Cooperative search cancellation.

The role of the reference's ``TInterruptFnPtr`` hook, polled inside
every long-running engine loop (reference:
NCBI c++/src/algo/blast/core/blast_engine.c:1140
``BLAST_SearchEngineCore`` interrupt checks and the G-BLASTN prelim
loop gpu_blastn_pre_search_engine.cpp:1437): the engine calls
``check(interrupt_fn)`` at stage boundaries; a truthy callback raises
``SearchInterrupted``, unwinding cleanly (device buffers and pipeline
queues are released by normal scope exit).
"""
from __future__ import annotations

from typing import Callable, Optional

InterruptFn = Optional[Callable[[], bool]]


class SearchInterrupted(RuntimeError):
    """The interrupt callback requested cancellation mid-search."""


def check(interrupt_fn: InterruptFn) -> None:
    if interrupt_fn is not None and interrupt_fn():
        raise SearchInterrupted("search interrupted by callback")
