"""Tiny copies of the benchmark's cells for CPU tests: the configuration
and traffic of a cell with a few short subjects, a few reads a batch and
a short pool."""
import copy

import pytest
import torch

from harness import check, data, spec

SUBJECTS = [["s1", 60_000], ["s2", 40_000]]
BUDGET = {"megablast": 6_000, "blastn": 4_500}


def tiny(cell_name, monkeypatch):
    """(config, traffic) of ``cell_name`` cut to a CPU test's size; the
    CLI's batch budgets patched to a few reads."""
    torch.set_num_threads(1)
    cell = spec.cell(cell_name)
    config = copy.deepcopy(spec.config(cell["config"]))
    traffic = copy.deepcopy(spec.traffic(cell["traffic"]))
    config["subjects"] = SUBJECTS
    traffic["pool_batches"] = 3
    monkeypatch.setattr(data, "BATCH_MEGABLAST", BUDGET["megablast"])
    monkeypatch.setattr(data, "BATCH_BLASTN", BUDGET["blastn"])
    monkeypatch.setattr(check, "SAMPLE", 200)
    return config, traffic


CELLS = pytest.mark.parametrize("cell_name", ["hg-mb.map", "chr1-bn.map"])
