"""One run of a cell: set-up, the measured window, the check.

Set-up makes the database and a pool of CLI batches from the seed and
runs the pool's first batch cold, through
``gblastn_tpu_torch.engine.search.search(batch, db, options, device=...)``
and ``format/render.py::ResultRenderer.emit`` into a tabular file under
``TMPDIR``. The window is the mix's loop (``benchmark/loops/<name>.py``,
named by the mix's ``loop``), which drives a ``Session``: the pool's
batches in turn, the search, the renderer and the clock. In a traced run
the profiler covers whole batches from the window's second until
``TRACE_SECONDS`` have passed; the per-layer metrics of the host's spans
are read from the other batches, which it leaves alone.
"""
from __future__ import annotations

import argparse
import gc
import os
import tempfile
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from gblastn_tpu_torch.cli.args import (
    _add_blastn_args,
    _build_options,
    _parse_outfmt,
)
from gblastn_tpu_torch.engine.search import search
from gblastn_tpu_torch.format.render import ResultRenderer
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import PAD, SequenceDB
from gblastn_tpu_torch.utils.profiling import slog

from harness import check, data
from harness import trace as tracing


@dataclass
class Run:
    """What a run measured; the metric readers read this."""

    batches: int = 0                  # window batches completed
    reads: int = 0                    # their reads
    window_s: float = 0.0
    setup_s: float = 0.0
    cold_batch_s: float = 0.0
    peak_bytes: int = 0
    batch_s: list = field(default_factory=list)  # each window batch
    batch_spans: list = field(default_factory=list)  # each one's slog
    # the window's batches that the profiler did not cover (all of them
    # in an untraced run): their count, slog totals and time in ``emit``
    span_batches: int = 0
    spans: dict = field(default_factory=dict)
    format_s: float = 0.0
    # the batches that the profiler covered, their bases and the trace
    traced_batches: int = 0
    seeding_bytes: float = 0.0        # bases of database and batches / 4
    trace: dict | None = None         # harness.trace.reduce of them


def options_of(config: dict):
    """The search options and output format as the CLI builds them from
    the configuration's command-line words."""
    p = argparse.ArgumentParser()
    _add_blastn_args(p)
    args = p.parse_args(config["cli"])
    options = _build_options(args)
    options.validate()
    kind, fields = _parse_outfmt(args.outfmt)
    return options, kind, fields, args.task


@contextmanager
def slog_annotated():
    """While tracing: each ``slog`` span also opens a profiler range of
    its name, so that the trace shows what the host was doing."""
    plain = slog.time

    @contextmanager
    def both(name):
        with torch.profiler.record_function(name), plain(name):
            yield

    slog.time = both
    try:
        yield
    finally:
        del slog.time


def make_inputs(config, traffic, seed, device):
    """The database and the pool of batches, from the seed."""
    genome = data.make_genome(config["subjects"], seed, PAD, device)
    budget = data.batch_budget(config["task"])
    reads = data.make_reads(genome, traffic, seed, budget,
                            int(traffic["pool_batches"]))
    db = SequenceDB(packed=genome.packed, starts=genome.starts,
                    lengths=genome.lengths, ids=genome.ids,
                    title=config["name"])
    first = np.concatenate([[0], np.cumsum(reads.batches)])
    batches = [[FastaRecord(check.read_id(i), "", reads.text(i))
                for i in range(first[b], first[b + 1])]
               for b in range(len(reads.batches))]
    return genome, reads, db, batches, first


TRACE_SECONDS = 5.0     # the profiler covers whole batches from the
                        # window's second until this much has passed


class Session:
    """What a window's loop (``benchmark/loops/<name>.py``) drives.

    ``take()`` hands out the pool's batches in turn (from the second: the
    first is set-up's cold batch), and from the start again where the
    window outlasts the pool, each time into a new output file, since the
    read ids repeat. ``search(records)`` is the program's ``search()``;
    ``emit(key, result)`` writes a result through the renderer;
    ``batch(key)`` brackets one batch's work (its clock, its ``slog``
    totals and, in a traced run, the profiler's stretch); ``over()`` says
    when the window has had its ``seconds``."""

    def __init__(self, run, batches, db, options, device, search_fn,
                 renderer, seconds, trace, genome_bases):
        self.run, self.batches, self.db = run, batches, db
        self.options, self.device = options, device
        self._search, self._renderer = search_fn, renderer
        self.seconds, self.trace = seconds, trace
        self._genome_bases = genome_bases
        self.emitted = []            # (output file, batch) in order
        self._b, self._cycle, self._out = len(batches), -1, None
        self.prof, self._stretch, self._note = None, None, None
        self.t_start = None

    def take(self):
        """(key, records) of the next batch."""
        if self._b == len(self.batches):
            self._b, self._cycle = 1, self._cycle + 1
            self._out = self._renderer()
        key = (self._cycle + 1, self._b)     # (output file, batch)
        self._b += 1
        return key, self.batches[key[1]]

    def search(self, records):
        return self._search(records, self.db, self.options,
                            device=self.device)

    def emit(self, key, result):
        t = time.perf_counter()
        with _note("bench.format", self.trace):
            self._out.emit(result)
        if not self._traced():
            self.run.format_s += time.perf_counter() - t
        self.emitted.append(key)

    def over(self) -> bool:
        return time.perf_counter() - self.t_start >= self.seconds

    def _traced(self) -> bool:
        return self._note is not None    # the profiler's stretch is open

    @contextmanager
    def batch(self, key):
        run = self.run
        if self.trace and self.prof is None and run.batches >= 1:
            self._start_trace()
        before = dict(slog.totals)
        t = time.perf_counter()
        with _note("bench.batch", self.trace):
            yield
            _sync(self.device)
        dt = time.perf_counter() - t
        mine = {k: v - before.get(k, 0.0) for k, v in slog.totals.items()
                if v != before.get(k, 0.0)}
        records = self.batches[key[1]]
        run.batches += 1
        run.reads += len(records)
        run.batch_s.append(dt)
        run.batch_spans.append(mine)
        if self._traced():
            run.traced_batches += 1
            run.seeding_bytes += (self._genome_bases + sum(
                r.length for r in records)) / 4
            if time.perf_counter() - self._stretch >= TRACE_SECONDS:
                self.stop_trace()
        else:
            run.span_batches += 1
            for k, v in mine.items():
                run.spans[k] = run.spans.get(k, 0.0) + v

    def _start_trace(self):
        self.prof = _profiler()
        self.prof.start()
        self._note = torch.profiler.record_function("bench.window")
        self._note.__enter__()
        self._stretch = time.perf_counter()

    def stop_trace(self):
        if self._note is not None:
            self._note.__exit__(None, None, None)
            self._note = None
            self.prof.stop()


def _note(name, trace):
    return torch.profiler.record_function(name) if trace else nullcontext()


def run_cell(config, traffic, limit, seed, seconds, trace, device,
             t0, search_fn=search, window=None):
    """Set up, measure for ``seconds`` and check; returns (Run, the
    check's summary). ``t0`` is the process's start on
    ``time.perf_counter``'s clock; ``window`` the mix's loop (by default
    the one that ``traffic["loop"]`` names)."""
    from harness import spec

    window = window or spec.loop(traffic["loop"])
    run = Run()
    options, kind, fields, task = options_of(config)
    genome, reads, db, batches, first = make_inputs(config, traffic, seed,
                                                   device)
    tmp = tempfile.TemporaryDirectory()
    try:
        out_files, renderers = [], []

        def renderer():
            path = Path(tmp.name) / f"out{len(out_files)}.tsv"
            out_files.append(path)
            fh = open(path, "w")
            r = ResultRenderer(kind, fields, fh, db, options,
                               dbname=config["name"], task=task)
            renderers.append((r, fh))
            return r

        cold = renderer()
        t = time.perf_counter()
        cold.emit(search_fn(batches[0], db, options, device=device))
        _sync(device)
        run.cold_batch_s = time.perf_counter() - t

        session = Session(run, batches, db, options, device, search_fn,
                          renderer, seconds, trace, len(genome.packed) * 4)
        slog.reset()
        with (slog_annotated() if trace else nullcontext()):
            session.t_start = time.perf_counter()
            run.setup_s = session.t_start - t0
            window(session)
            run.window_s = time.perf_counter() - session.t_start
            session.stop_trace()
        if device != "cpu":
            run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
        for r, fh in renderers:
            r.finalize()
            fh.close()
        emitted, prof = session.emitted, session.prof
        # the program's state goes before the reference runs
        del db, batches, renderers, cold, session
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        if prof is not None:
            path = Path(tmp.name) / "trace.json"
            prof.export_chrome_trace(str(path))
            del prof
            run.trace = tracing.reduce(tracing.load(path))
            path.unlink()
        summary = _check(genome, reads, config, limit, seed, emitted, first,
                         out_files, device)
    finally:
        tmp.cleanup()
    return run, summary


def _check(genome, reads, config, limit, seed, emitted, first, out_files,
           device):
    """Judge a sample of the reads of the window's batches; ``emitted``
    holds each batch's (output file, batch index)."""
    due = [(e, i) for e, (_f, b) in enumerate(emitted)
           for i in range(first[b], first[b + 1])]
    picked = check.sample(due, data.seed_words(seed))
    file_of = {e: f for e, (f, _b) in enumerate(emitted)}
    want: dict[int, set] = {}
    for e, i in picked:
        want.setdefault(file_of[e], set()).add(check.read_id(i))
    parsed = {f: check.parse_tabular(out_files[f], ids)
              for f, ids in want.items()}
    lines_of = {e: parsed[file_of[e]] for e, _i in picked}
    verdict = check.judge(genome, reads, config, picked, lines_of, device)
    return check.summarize(verdict, limit)


def _sync(device):
    if device != "cpu":
        torch.cuda.synchronize(device)


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def cache_dirs(root: Path) -> None:
    """Fixed directories in the checkout for every build and kernel cache
    that PyTorch may use; the program builds its own kernels and native
    library under ``build/gblastn_tpu_torch`` there."""
    base = root / "build" / "benchmark"
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(base / "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
