"""Native (C++) host runtime: build + ctypes bindings.

The host hot paths (per-seed greedy/DP gapped extension) run as native
code, the counterpart of the reference's C engine core. The port's copy
of ``gblastn_tpu/native/__init__.py``: it compiles the same C++ sources,
``native/*.cpp`` at the repository root, on first use with g++ -O3 into
``build/gblastn_tpu_torch/native/`` beside them (the JAX package keeps
its own library under the user's cache). Everything falls back to the
exact-parity Python implementations if the toolchain is unavailable
(GBLASTN_TPU_NO_NATIVE=1 forces the fallback).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC_DIR = _REPO_ROOT / "native"
_LIB_BASENAME = "libgblastn_native.so"

_lib = None
_tried = False


def _build_dir() -> Path:
    d = _REPO_ROOT / "build" / "gblastn_tpu_torch" / "native"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _needs_rebuild(lib_path: Path, sources: list[Path]) -> bool:
    if not lib_path.exists():
        return True
    mtime = lib_path.stat().st_mtime
    return any(s.stat().st_mtime > mtime for s in sources)


def _compile() -> Path | None:
    sources = sorted(_SRC_DIR.glob("*.cpp"))
    if not sources:
        return None
    lib_path = _build_dir() / _LIB_BASENAME
    if not _needs_rebuild(lib_path, sources):
        return lib_path
    # per-process tmp name: concurrent builders (pytest + bench) must not
    # clobber each other's output before their own os.replace
    tmp = lib_path.with_suffix(f".so.tmp.{os.getpid()}")
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-o", str(tmp), *[str(s) for s in sources],
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=300
        )
        os.replace(tmp, lib_path)
    except (subprocess.CalledProcessError, OSError,
            subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        # only trust an existing lib if it is now UP TO DATE (a
        # concurrent builder won the race); a stale cached .so would
        # bind old symbols against new Python callers
        if lib_path.exists() and not _needs_rebuild(lib_path, sources):
            return lib_path
        print(f"gblastn_tpu: native build failed ({e}); "
              "using Python fallback", file=sys.stderr)
        return None
    return lib_path


def get_lib():
    """The loaded native library, or None (Python fallback)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("GBLASTN_TPU_NO_NATIVE"):
        return None
    path = _compile()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        _bind_symbols(lib)
    except OSError as e:
        print(f"gblastn_tpu: native load failed ({e})", file=sys.stderr)
        return None
    except AttributeError as e:
        # symbol-incomplete library (e.g. stale cache + broken
        # toolchain): degrade to the Python twins rather than crash
        print(f"gblastn_tpu: native lib missing symbols ({e}); "
              "using Python fallback", file=sys.stderr)
        return None
    _lib = lib
    return _lib


def _bind_symbols(lib) -> None:
    lib.gblastn_greedy_align.restype = ctypes.c_int
    lib.gblastn_greedy_align.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,      # s1
        ctypes.c_void_p, ctypes.c_int64,      # s2
        ctypes.c_int, ctypes.c_int64,         # reverse, xdrop
        ctypes.c_int64, ctypes.c_int64,       # match, mismatch
        ctypes.c_int64, ctypes.c_int64,       # gap_open, gap_extend
        ctypes.c_int,                         # do_traceback
        ctypes.c_void_p, ctypes.c_void_p,     # op_types, op_nums
        ctypes.c_int64,                       # max_ops
        ctypes.c_void_p,                      # out_vals[7]
    ]
    lib.gblastn_greedy_gapped_traceback.restype = ctypes.c_int
    lib.gblastn_greedy_gapped_traceback.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,      # q, q_len
        ctypes.c_void_p, ctypes.c_int64,      # s, s_len
        ctypes.c_int64, ctypes.c_int64,       # xdrop, reward
        ctypes.c_int64,                       # penalty (negative)
        ctypes.c_int64, ctypes.c_int64,       # gap_open, gap_extend
        ctypes.c_int64, ctypes.c_int64,       # q_off, s_off
        ctypes.c_void_p, ctypes.c_void_p,     # op_types, op_nums
        ctypes.c_int64,                       # max_ops
        ctypes.c_void_p,                      # out int64[6]
    ]
    lib.gblastn_semi_gapped_align.restype = ctypes.c_int
    lib.gblastn_semi_gapped_align.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,      # A, a_avail
        ctypes.c_void_p, ctypes.c_int64,      # B, b_avail
        ctypes.c_int64, ctypes.c_int64,       # M, N
        ctypes.c_void_p,                      # matrix [16*16] int32
        ctypes.c_int64, ctypes.c_int64,       # gap_open, gap_extend
        ctypes.c_int64,                       # x_dropoff
        ctypes.c_int, ctypes.c_int,           # reverse, score_only
        ctypes.c_void_p, ctypes.c_void_p,     # op_types, op_nums
        ctypes.c_int64,                       # max_ops
        ctypes.c_void_p,                      # out_vals[4]
    ]
    lib.gblastn_dp_gapped_traceback.restype = ctypes.c_int
    lib.gblastn_dp_gapped_traceback.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,      # q, q_len
        ctypes.c_void_p, ctypes.c_int64,      # s, s_len
        ctypes.c_void_p,                      # matrix 16x16 int32
        ctypes.c_int64, ctypes.c_int64,       # gap_open, gap_extend
        ctypes.c_int64,                       # x_dropoff
        ctypes.c_int64, ctypes.c_int64,       # q_start, s_start
        ctypes.c_void_p, ctypes.c_void_p,     # op_types, op_nums
        ctypes.c_int64,                       # max_ops
        ctypes.c_void_p,                      # out int64[6]
    ]
    lib.gblastn_reevaluate_gapped.restype = ctypes.c_int64
    lib.gblastn_reevaluate_gapped.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,      # q, qlen
        ctypes.c_void_p, ctypes.c_int64,      # s, slen
        ctypes.c_void_p,                      # matrix 16x16 int32
        ctypes.c_int64, ctypes.c_int64,       # q_off, s_off
        ctypes.c_int64,                       # cutoff
        ctypes.c_int64, ctypes.c_int64,       # reward, penalty
        ctypes.c_int64, ctypes.c_int64,       # gap_open, gap_extend
        ctypes.c_void_p, ctypes.c_void_p,     # ops int8, nums int64
        ctypes.c_int64,                       # n_ops
        ctypes.c_void_p,                      # out int64[8]
    ]
    lib.gblastn_lut_build.restype = ctypes.c_int
    lib.gblastn_lut_build.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,      # buf, n
        ctypes.c_void_p, ctypes.c_int64,      # locs pairs, n_locs
        ctypes.c_int64, ctypes.c_int64,       # word_size, w
        ctypes.c_void_p, ctypes.c_void_p,     # offsets, positions
        ctypes.c_void_p,                      # pos_words
        ctypes.c_int64,                       # pos_cap
        ctypes.c_void_p,                      # out int64[2]
    ]
    lib.gblastn_gapped_prelim_walk.restype = ctypes.c_int64
    lib.gblastn_gapped_prelim_walk.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,      # qbuf, len
        ctypes.c_void_p, ctypes.c_int64,      # subject2, len
        ctypes.c_int64,                       # n candidates
        ctypes.c_void_p,                      # ctx int32
        ctypes.c_void_p, ctypes.c_void_p,     # uq_start, us_start
        ctypes.c_void_p, ctypes.c_void_p,     # length, score
        ctypes.c_void_p, ctypes.c_void_p,     # q_off, s_off
        ctypes.c_void_p,                      # reject uint8 or NULL
        ctypes.c_void_p, ctypes.c_void_p,     # ctx_offsets, ctx_len
        ctypes.c_void_p,                      # cutoff
        ctypes.c_int,                         # method 0 greedy / 1 DP
        ctypes.c_int64, ctypes.c_int64,       # reward, penalty
        ctypes.c_int64, ctypes.c_int64,       # gap_open, gap_extend
        ctypes.c_int64,                       # gap_x_dropoff
        ctypes.c_int64,                       # min_diag_separation
        ctypes.c_void_p,                      # matrix 16x16 or NULL
        ctypes.c_void_p, ctypes.c_void_p,     # o_q_off, o_q_end
        ctypes.c_void_p, ctypes.c_void_p,     # o_s_off, o_s_end
        ctypes.c_void_p, ctypes.c_void_p,     # o_score, o_ctx
        ctypes.c_void_p, ctypes.c_void_p,     # o_qg, o_sg
        ctypes.c_void_p,                      # out_n_ext int64[1]
    ]
    lib.gblastn_diag_order.restype = ctypes.c_int64
    lib.gblastn_diag_order.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q,s,oid
        ctypes.c_int64, ctypes.c_int64,       # n, diag_mask
        ctypes.c_void_p,                      # order out int64
    ]
    lib.gblastn_diag_filter.restype = ctypes.c_int64
    lib.gblastn_diag_filter.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q,s,oid
        ctypes.c_void_p, ctypes.c_int64,      # order, n
        ctypes.c_int64, ctypes.c_int64,       # word_size, window
        ctypes.c_int64,                       # diag_mask (0 = exact)
        ctypes.c_void_p, ctypes.c_void_p,     # ung_s_start, ung_length
        ctypes.c_void_p, ctypes.c_void_p,     # ung_score, cutoff
        ctypes.c_void_p,                      # right_run (or NULL)
        ctypes.c_void_p,                      # saved out uint8
    ]
    lib.gblastn_approx_ungapped.restype = ctypes.c_int64
    lib.gblastn_approx_ungapped.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,      # query, concat_end
        ctypes.c_void_p,                      # packed db
        ctypes.c_void_p,                      # table int32[256]
        ctypes.c_int64,                       # n
        ctypes.c_void_p, ctypes.c_void_p,     # sub_start, sub_end
        ctypes.c_void_p, ctypes.c_void_p,     # q_off, s_off
        ctypes.c_void_p,                      # ctx int32
        ctypes.c_void_p, ctypes.c_void_p,     # x_dropoffs, reduced
        ctypes.c_void_p,                      # need uint8
        ctypes.c_void_p,                      # demote out uint8
        ctypes.c_void_p, ctypes.c_void_p,     # a_score, a_q
        ctypes.c_void_p, ctypes.c_void_p,     # a_s, a_r
    ]
    lib.gblastn_dust_mask.restype = ctypes.c_int64
    lib.gblastn_dust_mask.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,      # seq2, n
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # level, window, linker
        ctypes.c_void_p, ctypes.c_int64,      # out pairs, cap
    ]


def native_available() -> bool:
    return get_lib() is not None
