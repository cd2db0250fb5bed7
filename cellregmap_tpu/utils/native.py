"""Build and load the native host libraries (Davies' method, PLINK decode).

The C++ sources live in ``cellregmap_tpu/native`` and are compiled with g++
on first use into ``<checkout>/.cache/native``; each library's name carries
a digest of its source, so an edited source is rebuilt.  A failed build
raises with the compiler's output: the exact p-value path has no silent
substitute.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .._config import CACHE_ROOT

_NATIVE_SRC = Path(__file__).resolve().parent.parent / "native"


def _build(source_name: str) -> Path:
    """Compile ``native/<source_name>`` into the cache; returns its path."""
    src = _NATIVE_SRC / source_name
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = CACHE_ROOT / "native" / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename into place: concurrent first uses
    # (test workers, threads) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp,
             str(src), "-lpthread"],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src.name} failed:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load_library(source_name: str) -> ctypes.CDLL:
    """The native library built from ``native/<source_name>`` (cached)."""
    return ctypes.CDLL(str(_build(source_name)))


class QfcLib:
    """Thin typed wrapper over the shared library."""

    def __init__(self, cdll: ctypes.CDLL):
        self._lib = cdll
        self._lib.qfc_survival.restype = ctypes.c_double
        self._lib.qfc_survival.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # lb
            ctypes.POINTER(ctypes.c_double),  # nc
            ctypes.POINTER(ctypes.c_int),     # df
            ctypes.c_int,                     # r
            ctypes.c_double,                  # sigma
            ctypes.c_double,                  # q
            ctypes.c_int,                     # lim
            ctypes.c_double,                  # acc
            ctypes.POINTER(ctypes.c_int),     # ifault
        ]
        self._lib.qfc_survival_batch.restype = None
        self._lib.qfc_survival_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # lambdas
            ctypes.POINTER(ctypes.c_double),  # qs
            ctypes.c_int, ctypes.c_int,       # n_problems, c
            ctypes.c_int, ctypes.c_double,    # lim, acc
            ctypes.c_double, ctypes.c_int,    # filter_ratio, n_threads
            ctypes.POINTER(ctypes.c_double),  # out_pv
            ctypes.POINTER(ctypes.c_int),     # out_fault
        ]

    def davies(self, lambdas: np.ndarray, q: float, lim: int, acc: float):
        """P(Q > q) for the central chi2(1) mixture; returns (pv, ifault)."""
        lam = np.ascontiguousarray(lambdas, dtype=np.float64)
        ifault = ctypes.c_int(0)
        pv = self._lib.qfc_survival(
            lam.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            None, None, lam.shape[0], 0.0, float(q), int(lim), float(acc),
            ctypes.byref(ifault),
        )
        return float(pv), int(ifault.value)

    def davies_general(self, lambdas, ncps, dfs, sigma, q, lim, acc):
        lam = np.ascontiguousarray(lambdas, dtype=np.float64)
        nc = np.ascontiguousarray(ncps, dtype=np.float64)
        df = np.ascontiguousarray(dfs, dtype=np.int32)
        ifault = ctypes.c_int(0)
        pv = self._lib.qfc_survival(
            lam.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            df.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            lam.shape[0], float(sigma), float(q), int(lim), float(acc),
            ctypes.byref(ifault),
        )
        return float(pv), int(ifault.value)

    def davies_batch(self, lambda_rows, qs, lim, acc, filter_ratio,
                     n_threads=0):
        """Threaded batch; lambda_rows (S, C) zero-padded; returns pv (S,).

        Problems the algorithm cannot handle (ifault != 0) fall back to the
        Python ladder (Imhof / modified Liu) one by one.
        """
        lam = np.ascontiguousarray(lambda_rows, dtype=np.float64)
        qs = np.ascontiguousarray(qs, dtype=np.float64)
        n, c = lam.shape
        pv = np.empty(n, dtype=np.float64)
        fault = np.empty(n, dtype=np.int32)
        self._lib.qfc_survival_batch(
            lam.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            qs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, c, int(lim), float(acc), float(filter_ratio), int(n_threads),
            pv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            fault.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        bad = np.nonzero(fault != 0)[0]
        if bad.size:
            from ..models.pvalues import davies_pvalue

            for i in bad:
                pv[i] = davies_pvalue(
                    qs[i], lambdas=lam[i], lim=lim, acc=acc,
                    lambda_filter_ratio=filter_ratio,
                )
        return pv


@functools.lru_cache(maxsize=None)
def get_qfc() -> QfcLib:
    """The native Davies library, built on first use."""
    return QfcLib(load_library("qfc.cc"))
