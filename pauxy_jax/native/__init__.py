"""Native (C++) runtime components, loaded via ctypes.

The device compute path is jax/XLA; the host runtime around it (here:
the FCIDUMP data loader, whose text parse dominates setup for molecular
integral files) is C++ compiled on demand with the system toolchain and
called through the C ABI — no build step at install time, no binding
dependency.  Every native entry point has a pure-Python behavioural oracle
(``utils/qmcpack.read_fcidump``) used as the fallback when a compiler is
unavailable or ``PAUXY_NO_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB = None
_LIB_ERR = None


def _build(src: str, out: str) -> None:
    """Compile src -> shared library atomically (temp + rename), so
    concurrent test workers never load a half-written .so."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", src, "-o", tmp],
            check=True, capture_output=True, text=True, timeout=120,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    """Build (if stale) and dlopen the native library; cache the result."""
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        if os.environ.get("PAUXY_NO_NATIVE"):
            _LIB_ERR = "disabled by PAUXY_NO_NATIVE"
            return None
        src = os.path.join(_HERE, "fcidump.cpp")
        out = os.path.join(_HERE, "_pauxy_native.so")
        try:
            if (not os.path.exists(out)
                    or os.path.getmtime(out) < os.path.getmtime(src)):
                _build(src, out)
            lib = ctypes.CDLL(out)
            fn = lib.pauxy_fcidump_fill
            fn.restype = ctypes.c_long
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
            ]
            _LIB = lib
        except (OSError, subprocess.SubprocessError) as e:
            _LIB_ERR = f"{type(e).__name__}: {e}"
            return None
    return _LIB


def available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    _load()
    return _LIB_ERR


def fcidump_fill(body: bytes, norb: int, cplx: bool):
    """Parse an FCIDUMP body (everything after &END) natively.

    Returns (h1e [norb, norb], eri [norb]*4, ecore) with float64 or
    complex128 dtype, or None when the native library is unavailable.
    Raises ValueError on a malformed body (byte offset included; this
    covers out-of-range orbital indices, which the C side validates before
    any array store). The caller (utils/qmcpack.read_fcidump) warns with
    the offset and retries with the permissive Python parser.
    """
    lib = _load()
    if lib is None:
        return None
    dtype = np.complex128 if cplx else np.float64
    h1e = np.zeros((norb, norb), dtype=dtype)
    eri = np.zeros((norb, norb, norb, norb), dtype=dtype)
    ecore = np.zeros(1, dtype=dtype)
    dptr = ctypes.POINTER(ctypes.c_double)
    n = lib.pauxy_fcidump_fill(
        body, len(body), norb, int(cplx),
        h1e.ctypes.data_as(dptr), eri.ctypes.data_as(dptr),
        ecore.ctypes.data_as(dptr),
    )
    if n < 0:
        raise ValueError(
            f"malformed FCIDUMP entry near byte {-n - 1} of the body"
        )
    return h1e, eri, complex(ecore[0]) if cplx else float(ecore[0])
