"""ctypes bridge to the native linear-solver library.

Compiles ``linear_solvers.cpp`` with g++ on first use (cached as
``_linear_solvers.so`` beside the source; rebuilt when the source is
newer).  No third-party binding layer required.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "linear_solvers.cpp")
_LIB = os.path.join(_HERE, "_linear_solvers.so")
_lock = threading.Lock()
_lib = None


def _build() -> None:
    # build beside the target and rename: processes that build or load
    # the library at the same time (parallel test workers) only ever
    # see a complete file
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-std=c++17", "-O3", "-march=native", "-fPIC", "-shared",
           "-fopenmp", _SRC, "-o", tmp]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except subprocess.CalledProcessError:
            # retry without OpenMP / -march for maximal portability
            cmd = ["g++", "-std=c++17", "-O3", "-fPIC", "-shared", _SRC,
                   "-o", tmp]
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB) or
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB)
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        lib.ipm_ldlt_factor.argtypes = [dp, ctypes.c_int64, dp, dp,
                                        ctypes.c_double]
        lib.ipm_ldlt_factor.restype = ctypes.c_int
        lib.ipm_ldlt_solve.argtypes = [dp, dp, dp, ctypes.c_int64]
        lib.ipm_ldlt_solve.restype = ctypes.c_int
        lib.ipm_ldlt_factor_solve_batch.argtypes = [
            dp, dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, dp]
        lib.ipm_ldlt_factor_solve_batch.restype = ctypes.c_int
        lib.ipm_bunch_kaufman_factor.argtypes = [dp, ctypes.c_int64, dp, ip]
        lib.ipm_bunch_kaufman_factor.restype = ctypes.c_int
        lib.ipm_bunch_kaufman_solve.argtypes = [dp, ip, dp, ctypes.c_int64]
        lib.ipm_bunch_kaufman_solve.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def ldlt_factor(A: np.ndarray, pivot_floor: float = 1e-8):
    """Return (L, D) with A = L D L^T, zero pivots floored."""
    lib = _load()
    A = np.ascontiguousarray(A, dtype=np.float64)
    n = A.shape[0]
    L = np.zeros((n, n), np.float64)
    D = np.zeros((n,), np.float64)
    lib.ipm_ldlt_factor(_dptr(A), n, _dptr(L), _dptr(D), pivot_floor)
    return L, D


def ldlt_solve(L: np.ndarray, D: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(b, dtype=np.float64).copy()
    lib.ipm_ldlt_solve(_dptr(np.ascontiguousarray(L, np.float64)),
                       _dptr(np.ascontiguousarray(D, np.float64)),
                       _dptr(x), L.shape[0])
    return x


def ldlt_factor_solve_batch(A: np.ndarray, b: np.ndarray,
                            pivot_floor: float = 1e-8) -> np.ndarray:
    """Solve a batch: A (nb,n,n), b (nb,n) -> x (nb,n), OpenMP-parallel."""
    lib = _load()
    A = np.ascontiguousarray(A, dtype=np.float64)
    x = np.ascontiguousarray(b, dtype=np.float64).copy()
    nb, n = x.shape
    ws = np.empty((nb, n * n + n), np.float64)
    lib.ipm_ldlt_factor_solve_batch(_dptr(A), _dptr(x), nb, n, pivot_floor,
                                    _dptr(ws))
    return x


def bunch_kaufman_factor(A: np.ndarray):
    """Return (F, ipiv, info): Bunch-Kaufman factorisation of symmetric A."""
    lib = _load()
    A = np.ascontiguousarray(A, dtype=np.float64)
    n = A.shape[0]
    F = np.zeros((n, n), np.float64)
    ipiv = np.zeros((n,), np.int64)
    info = lib.ipm_bunch_kaufman_factor(_dptr(A), n, _dptr(F), _iptr(ipiv))
    return F, ipiv, info


def bunch_kaufman_solve(F: np.ndarray, ipiv: np.ndarray,
                        b: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(b, dtype=np.float64).copy()
    lib.ipm_bunch_kaufman_solve(
        _dptr(np.ascontiguousarray(F, np.float64)),
        _iptr(np.ascontiguousarray(ipiv, np.int64)), _dptr(x), F.shape[0])
    return x


class NativeLinearSolvers:
    """Object-style facade (handy for dependency injection in tests)."""

    ldlt_factor = staticmethod(ldlt_factor)
    ldlt_solve = staticmethod(ldlt_solve)
    ldlt_factor_solve_batch = staticmethod(ldlt_factor_solve_batch)
    bunch_kaufman_factor = staticmethod(bunch_kaufman_factor)
    bunch_kaufman_solve = staticmethod(bunch_kaufman_solve)
