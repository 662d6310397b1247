"""Device seeding: ms a window batch in the ``slog`` span
``device.seeding`` (both parts: the launch, then the fetch that waits),
over the batches that the profiler left alone."""


def read(run):
    if not run.span_batches or "device.seeding" not in run.spans:
        return None
    return 1e3 * run.spans["device.seeding"] / run.span_batches
