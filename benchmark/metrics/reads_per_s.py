"""Throughput: every read of the window's whole batches over the whole
window (harness clock), warm."""


def read(run):
    if not run.batches or not run.window_s:
        return None
    return run.reads / run.window_s
