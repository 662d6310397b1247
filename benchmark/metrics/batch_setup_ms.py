"""Batch set-up: ms a window batch in the ``slog`` spans
``setup.query_block``, ``setup.dust`` and ``setup.lookup_table``, over
the batches that the profiler left alone."""

SPANS = ("setup.query_block", "setup.dust", "setup.lookup_table")


def read(run):
    if not run.span_batches or "setup.query_block" not in run.spans:
        return None
    return 1e3 * sum(run.spans.get(s, 0.0) for s in SPANS) / run.span_batches
