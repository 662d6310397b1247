"""Device idle share: the traced stretch's time with no kernel, copy or
fill on the card, over the stretch (profiler trace of whole batches)."""


def read(run):
    t = run.trace
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
