"""Set-up: process start to the window's start (harness clock)."""


def read(run):
    return run.setup_s or None
