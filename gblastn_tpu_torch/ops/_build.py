"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled at first use with ``nvcc`` -- one
``nvcc`` process per source, all started together -- and the objects are
linked into one shared library with a plain C interface under
``build/gblastn_tpu_torch/`` at the repository root, loaded with
``ctypes``. No PyTorch headers are included, so a build takes seconds.
Nothing here runs at import time: ``load()`` is called by a kernel
wrapper when it first sees a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "gblastn_tpu_torch"
_LIB_NAME = "libgblastn_torch_kernels.so"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib = None
build_log = ""        # nvcc's output of the library's build (ptxas register
                      # use), kept beside it and read back when it is current


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "gblastn_tpu_torch are built from csrc/ at first use"
    )


def build() -> Path:
    """Compile csrc/*.cu into the shared library if it or its build log
    is missing or older than a source; returns its path and sets
    ``build_log`` (from the log file when nothing is built). Raises on a
    failed build."""
    global build_log
    sources = sorted(_SRC_DIR.glob("*.cu"))
    lib_path = BUILD_DIR / _LIB_NAME
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists() and log_path.exists() and all(
        s.stat().st_mtime <= min(lib_path.stat().st_mtime,
                                 log_path.stat().st_mtime)
        for s in sources
    ):
        build_log = log_path.read_text()
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(sources, objs)
    ]
    logs, failed = [], []
    try:
        for s, pr in zip(sources, procs):
            out, _ = pr.communicate(timeout=600)
            logs.append(f"== {s.name}\n{out}")
            if pr.returncode != 0:
                failed.append(f"{s.name} ({pr.returncode})")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    build_log = "".join(logs)
    tmp = lib_path.with_suffix(f".so.{tag}")
    try:
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n{build_log}")
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        os.replace(tmp, lib_path)
        log_tmp = log_path.with_suffix(f".log.{tag}")
        log_tmp.write_text(build_log)
        os.replace(log_tmp, log_path)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return lib_path


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.gblastn_ungapped_xdrop          # K1
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 8        # query .. max_r
            + [ctypes.c_int] * 2         # n, Q
            + [ctypes.c_longlong]        # S
            + [ctypes.c_void_p] * 5      # five outputs
            + [ctypes.c_void_p]          # stream
        )
        fn = lib.gblastn_gapped_band             # K2
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 9        # query, subject, matrix, a0 .. x,
                                         # order
            + [ctypes.c_int] * 5         # n_jobs, n_right, rows, open, ext
            + [ctypes.c_void_p] * 2      # score, flags
            + [ctypes.c_void_p]          # stream
        )
        fn = lib.gblastn_table_gather            # P1-P3
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int]                       # device
            + [ctypes.c_void_p, ctypes.c_int] * 2    # tab, n_tab, idx, n
            + [ctypes.c_void_p]                  # out
            + [ctypes.c_int] * 5     # staged, cluster, clusters, slice, shift
            + [ctypes.c_void_p]                  # stream
        )
        fn = lib.gblastn_table_gather_clusters   # its occupancy query
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn = lib.gblastn_approx_gate             # G
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6        # qbytes, packed, table256,
                                         # ctx_tables, sub_starts, sub_ends
            + [ctypes.c_void_p] * 9      # q_off .. ug_score, right_run
            + [ctypes.c_int]             # QB
            + [ctypes.c_longlong]        # P
            + [ctypes.c_int] * 5         # n_ctx, n_sub, n, word, concat_end
            + [ctypes.c_void_p] * 5      # five outputs
            + [ctypes.c_void_p]          # stream
        )
        fn = lib.gblastn_diag_replay             # R
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 7        # key, order, s_loc, end_loc,
                                         # score, cutoff, right_run
            + [ctypes.c_int] * 5         # n, word, window, key_shift, wide
            + [ctypes.c_void_p] * 2      # saved, stream
        )
        fn = lib.gblastn_right_run               # RR
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6        # query_nib, subject_w, sub_ends,
                                         # q_off, s_off, oid
            + [ctypes.c_int]             # Q8
            + [ctypes.c_longlong]        # S16
            + [ctypes.c_int] * 3         # n_sub, n, word
            + [ctypes.c_void_p] * 2      # out, stream
        )
        fn = lib.gblastn_empty_launch            # the launch floor
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]   # blocks, stream
        _lib = lib
    return _lib


def build_one(source: Path, name: str) -> ctypes.CDLL:
    """One ``.cu`` source alone, compiled into
    ``build/gblastn_tpu_torch/compare/<name>.<hash>.so`` and loaded
    (unbound); the hash is the source text's, so sources of one name from
    two checkouts never share a library. For the profilers' comparisons
    only (another commit's kernel); the port's paths load ``load()``'s
    library."""
    source = Path(source)
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / "compare" / f"{name}.{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
               str(source)]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
