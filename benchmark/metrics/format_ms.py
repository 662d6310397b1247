"""Tabular output: ms a window batch inside ``ResultRenderer.emit``
(harness clock), over the batches that the profiler left alone."""


def read(run):
    if not run.span_batches:
        return None
    return 1e3 * run.format_s / run.span_batches
