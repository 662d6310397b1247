"""Traceback: ms a window batch in the ``slog`` span ``host.traceback``,
over the batches that the profiler left alone."""


def read(run):
    if not run.span_batches or "host.traceback" not in run.spans:
        return None
    return 1e3 * run.spans["host.traceback"] / run.span_batches
