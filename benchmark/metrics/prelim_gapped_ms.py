"""Host gapped prelim (with K2 where it engages): ms a window batch in
the ``slog`` span ``host.prelim_gapped``, over the batches that the
profiler left alone."""


def read(run):
    if not run.span_batches or "host.prelim_gapped" not in run.spans:
        return None
    return 1e3 * run.spans["host.prelim_gapped"] / run.span_batches
