"""The import guard compares whole top-level names, and a run without a
card, or without the program beside the benchmark, prints no result."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

from harness.guard import FORBIDDEN, forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]


def test_guard_compares_whole_top_level_names():
    seen = ["gblastn_tpu_torch", "gblastn_tpu_torch.engine.search",
            "jaxtyping", "benchmark_tools", "flax_free"]
    assert forbidden_loaded(seen) == []
    assert forbidden_loaded(seen + ["gblastn_tpu.engine", "jax.numpy",
                                    "jaxlib", "bench", "chip_smoke"]) == [
        "bench", "chip_smoke", "gblastn_tpu", "jax", "jaxlib"]
    assert "flax" in FORBIDDEN


def test_what_a_run_imports_loads_nothing_forbidden():
    code = (
        "import sys; sys.path[:0] = ['benchmark', '.'];"
        "import run, control; from harness import loop, check, trace;"
        "import reference.align;"
        "from harness import spec;"
        "[spec.metric_reader(m['name']) for m in spec.benchmark()['per_layer']];"
        "from harness.guard import forbidden_loaded;"
        "print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "hg-mb.map",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
