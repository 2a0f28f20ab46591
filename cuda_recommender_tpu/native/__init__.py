"""Native (C++) host tooling: text parsing, ELL packing, and grouping.

The reference's only native host code is its C++ driver/loader stack
(/root/reference/src/*.cpp); this framework keeps Python as the host
program and pushes the data-preparation hot paths to C++ via a small
ctypes-bound shared library, with transparent NumPy fallbacks when the
toolchain is unavailable: text-ratings parsing (textparse), padded-ELL
bucket fill (ellfill), and the stable counting sort behind the dual
CSR+CSC build and the hybrid panel split (groupsort).

Build: ``python -m cuda_recommender_tpu.native.build`` (or automatic on first
import when g++ is present — a ~1 s compile, cached next to this file).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libcrtpu_native.so")
_SRC = [os.path.join(_DIR, "src", f)
        for f in ("textparse.cpp", "ellfill.cpp", "groupsort.cpp")]

_lib = None


def build(force: bool = False, verbose: bool = False) -> str:
    """Compile the shared library. Returns the .so path."""
    if not force and os.path.exists(_SO) and all(
            os.path.getmtime(_SO) >= os.path.getmtime(s) for s in _SRC):
        return _SO
    # per-process tmp name: concurrent auto-builds (pytest workers, multihost
    # launches) must not interleave writes into one tmp file and publish a
    # corrupted library
    tmp = f"{_SO}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17",
           "-o", tmp, *_SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise OSError(f"native build failed: {res.stderr[-2000:]}")
    os.replace(tmp, _SO)
    if verbose:
        print(f"[info] built {_SO}", file=sys.stderr)
    return _SO


def lib() -> ctypes.CDLL:
    """The loaded shared library (builds on demand). Raises OSError if no
    toolchain/library is available — callers fall back to NumPy paths."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or any(
            os.path.getmtime(_SO) < os.path.getmtime(s) for s in _SRC):
        build()
    L = ctypes.CDLL(_SO)
    i64, i32, f32, c = (ctypes.POINTER(ctypes.c_int64),
                        ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_float), ctypes.c_int64)
    L.crtpu_count_lines.restype = ctypes.c_longlong
    L.crtpu_count_lines.argtypes = [ctypes.c_char_p]
    L.crtpu_parse_ratings.restype = ctypes.c_longlong
    L.crtpu_parse_ratings.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_longlong, i64, i64, f32]
    L.crtpu_ell_fill.restype = None
    L.crtpu_ell_fill.argtypes = [i64, i32, f32, i32, i64,
                                 c, c, c, c, c, c, ctypes.c_int32, i32, f32]
    L.crtpu_key_count.restype = None
    L.crtpu_key_count.argtypes = [i32, c, c, i64]
    L.crtpu_stable_perm.restype = None
    L.crtpu_stable_perm.argtypes = [i32, c, c, i64, i64]
    L.crtpu_perm_gather.restype = None
    L.crtpu_perm_gather.argtypes = [i64, c, i32, f32, i32, f32]
    _lib = L
    return L


def available() -> bool:
    try:
        lib()
        return True
    except OSError:
        return False
