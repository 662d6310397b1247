"""The benchmark's own tests: on the CPU at tiny sizes, and the few that
need a card (marker ``cuda``, as in the repository's tests)."""
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips with a reason elsewhere)"
    )
