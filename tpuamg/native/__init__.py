"""ctypes loader for the native amgkit library (C++ host setup kernels).

Builds `amgkit.cpp` + `tailkit.cpp` with g++ -O3 on first use into
`build/` next to the sources (listed in .gitignore; `-march=native` is
safe because the library is built on the machine that runs it).  Every
entry point has a vectorized-numpy fallback in the pure-Python modules,
so absence of a toolchain only costs setup speed.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "amgkit.cpp"),
         os.path.join(_HERE, "tailkit.cpp")]
_BUILD_DIR = os.path.join(_HERE, "build")
_LIB = os.path.join(_BUILD_DIR, "libamgkit.so")

_lib = None


def _build():
    """Compile to a temporary name, then rename: concurrent first users
    (test workers) never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
               "-fPIC", "-o", tmp] + _SRCS
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < max(os.path.getmtime(s)
                                                for s in _SRCS)):
            _build()
        lib = ctypes.CDLL(_LIB)
    except (OSError, subprocess.CalledProcessError):
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")

    lib.coo_to_csr.argtypes = [ctypes.c_int64, ctypes.c_int64,
                               i64p, i64p, f64p, i64p, i32p, f64p]
    lib.coo_to_csr.restype = ctypes.c_int64
    lib.csr_spgemm_count.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                     i64p, i32p, i64p, i32p, i64p]
    lib.csr_spgemm_fill.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                    i64p, i32p, f64p, i64p, i32p, f64p,
                                    i64p, i32p, f64p]
    lib.greedy_color.argtypes = [ctypes.c_int64, i64p, i32p,
                                 ctypes.c_int32, i32p]
    lib.vmb_aggregation.argtypes = [ctypes.c_int64, i64p, i32p,
                                    ctypes.c_int64, i64p]
    lib.vmb_aggregation.restype = ctypes.c_int64
    lib.hem_matching.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                 i64p, i32p, f64p, i64p]
    lib.hem_matching.restype = ctypes.c_int64
    lib.greedy_mis.argtypes = [ctypes.c_int64, i64p, i32p, u8p, u8p]
    lib.greedy_mis.restype = ctypes.c_int64
    _lib = lib
    return _lib


# -- numpy-facing wrappers -------------------------------------------------

def native_spgemm(A, B):
    """C = A @ B via native Gustavson; returns HostCSR or None."""
    lib = get_lib()
    if lib is None:
        return None
    from ..sparse.host import HostCSR
    n, k = A.shape
    _, m = B.shape
    c_indptr = np.zeros(n + 1, dtype=np.int64)
    a_ip = np.ascontiguousarray(A.indptr, dtype=np.int64)
    a_ix = np.ascontiguousarray(A.indices, dtype=np.int32)
    b_ip = np.ascontiguousarray(B.indptr, dtype=np.int64)
    b_ix = np.ascontiguousarray(B.indices, dtype=np.int32)
    lib.csr_spgemm_count(n, m, a_ip, a_ix, b_ip, b_ix, c_indptr)
    nnz = int(c_indptr[-1])
    c_ix = np.empty(nnz, dtype=np.int32)
    c_dt = np.empty(nnz, dtype=np.float64)
    lib.csr_spgemm_fill(n, m, a_ip, a_ix,
                        np.ascontiguousarray(A.data, dtype=np.float64),
                        b_ip, b_ix,
                        np.ascontiguousarray(B.data, dtype=np.float64),
                        c_indptr, c_ix, c_dt)
    return HostCSR(c_indptr, c_ix, c_dt, (n, m))


def native_coo_to_csr(rows, cols, vals, shape):
    """COO -> canonical coalesced CSR (duplicates summed); None if the
    native library is unavailable.  Returns (indptr, indices, data)."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(shape[0])
    nnz = len(rows)
    indptr = np.empty(n + 1, dtype=np.int64)
    out_cols = np.empty(nnz, dtype=np.int32)
    out_vals = np.empty(nnz, dtype=np.float64)
    w = lib.coo_to_csr(n, nnz,
                       np.ascontiguousarray(rows, dtype=np.int64),
                       np.ascontiguousarray(cols, dtype=np.int64),
                       np.ascontiguousarray(vals, dtype=np.float64),
                       indptr, out_cols, out_vals)
    return indptr, out_cols[:w].copy(), out_vals[:w].copy()


def native_greedy_color(A, max_colors=24):
    lib = get_lib()
    if lib is None:
        return None
    n = A.shape[0]
    colors = np.empty(n, dtype=np.int32)
    lib.greedy_color(n, np.ascontiguousarray(A.indptr, dtype=np.int64),
                     np.ascontiguousarray(A.indices, dtype=np.int32),
                     max_colors, colors)
    return colors


def native_vmb(S, max_aggregation=100):
    lib = get_lib()
    if lib is None:
        return None
    n = S.shape[0]
    agg = np.empty(n, dtype=np.int64)
    nagg = lib.vmb_aggregation(
        n, np.ascontiguousarray(S.indptr, dtype=np.int64),
        np.ascontiguousarray(S.indices, dtype=np.int32),
        max_aggregation, agg)
    return agg, int(nagg)


def native_hem(S):
    """Serial greedy HEM (quality-optimal ordering). Returns match array."""
    lib = get_lib()
    if lib is None:
        return None
    n = S.shape[0]
    rows = np.ascontiguousarray(S.rows_expanded(), dtype=np.int64)
    match = np.empty(n, dtype=np.int64)
    lib.hem_matching(n, S.nnz, rows,
                     np.ascontiguousarray(S.indices, dtype=np.int32),
                     np.ascontiguousarray(S.data, dtype=np.float64),
                     match)
    return match


def native_mis(G, candidates):
    lib = get_lib()
    if lib is None:
        return None
    n = G.shape[0]
    cand = np.zeros(n, dtype=np.uint8)
    cand[np.asarray(candidates)] = 1
    seed = np.empty(n, dtype=np.uint8)
    lib.greedy_mis(n, np.ascontiguousarray(G.indptr, dtype=np.int64),
                   np.ascontiguousarray(G.indices, dtype=np.int32),
                   cand, seed)
    return np.flatnonzero(seed).astype(np.int64)
