"""Scan and mini-extension: device ms a traced batch of the kernels in
its seeding spans that are not K1, RR, G, R or the sort (profiler
trace)."""


def read(run):
    t = run.trace
    if not t or not run.traced_batches or not t["seeding_kernel_s"]:
        return None
    return 1e3 * t["scan_kernel_s"] / run.traced_batches
