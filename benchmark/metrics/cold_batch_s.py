"""Set-up's cold batch: seconds of the first batch of the run
through ``search()`` and ``emit`` (harness clock); the host's subject
caches fill in it."""


def read(run):
    return run.cold_batch_s or None
