"""Device seeding against its floor: the least time to read the
database's and each traced batch's bases once at 2 bits each at the
H100's 3.35 TB/s, over the device time of every kernel in those batches'
seeding spans (profiler trace). A floor of the work, whatever implements
it."""

from harness.peaks import H100


def read(run):
    t = run.trace
    if not t or not t["seeding_kernel_s"]:
        return None
    least = run.seeding_bytes / H100["hbm_bytes_per_s"]
    return 100.0 * least / t["seeding_kernel_s"]
