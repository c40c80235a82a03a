"""ctypes bridge to the native host library (native/libnbody_host.so).

Four entry points of that library are used: the glibc-rand init loop
(large N: milliseconds against seconds in Python), the raw glibc ``rand()``
stream, the snprintf final-state formatter (the reference's own printf
semantics) and the mmap PPM frame blit.  All are bit-identical to the Python implementations, which remain the
fallback when the library is missing or does not load (``make -C native``
builds it).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libnbody_host.so")


@functools.cache
def load():
    """Load the native library; None if it is missing or does not load."""
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.nbody_glibc_rand_fill.argtypes = [
        ctypes.c_uint32, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    lib.nbody_glibc_rand_fill.restype = None
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.nbody_init.argtypes = [ctypes.c_uint32, ctypes.c_int64,
                               ctypes.c_int32, ctypes.c_int32,
                               dptr, dptr, dptr, dptr, dptr, dptr]
    lib.nbody_init.restype = None
    lib.nbody_ppm_blit.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64]
    lib.nbody_ppm_blit.restype = ctypes.c_int
    lib.nbody_format_state.argtypes = [
        ctypes.c_int64, dptr, dptr, dptr, dptr, dptr, dptr,
        ctypes.c_char_p, ctypes.c_int64]
    lib.nbody_format_state.restype = ctypes.c_int64
    return lib


def available() -> bool:
    return load() is not None


def nbody_init(n: int, xdim: int, ydim: int, seed: int):
    """Native reference init; returns (x, y, xv, yv, mass, radius) float64."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library %s is unavailable" % _LIB_PATH)
    arrs = [np.empty(n, np.float64) for _ in range(6)]
    lib.nbody_init(seed, n, xdim, ydim, *arrs)
    return tuple(arrs)


def glibc_rand_fill(seed: int, n: int) -> np.ndarray:
    """The first ``n`` values of glibc ``rand()`` after ``srand(seed)``
    (int64), from the native library."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library %s is unavailable" % _LIB_PATH)
    out = np.empty(n, np.int64)
    lib.nbody_glibc_rand_fill(seed, n, out)
    return out


def format_state_native(x, y, xf, yf, xv, yv) -> str | None:
    """Reference final-state printout via C snprintf (exact printf
    semantics); None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = x.shape[0]
    # %10.3f widens for huge magnitudes; 64 bytes/field is ample headroom.
    line_cap = 6 * 64
    buf = ctypes.create_string_buffer(n * line_cap + 1)
    args = [np.ascontiguousarray(a, np.float64)
            for a in (x, y, xf, yf, xv, yv)]
    nbytes = lib.nbody_format_state(n, *args, buf, line_cap)
    if nbytes < 0:
        return None
    return buf.raw[:nbytes].decode("ascii")


def ppm_blit(path: str, data_offset: int, pixels: np.ndarray) -> bool:
    """Write ``pixels`` over the file's pixel data through the library's
    mmap blit; False when the library is unavailable or the blit fails (the
    caller then seeks and writes)."""
    lib = load()
    if lib is None:
        return False
    pixels = np.ascontiguousarray(pixels, np.uint8)
    rc = lib.nbody_ppm_blit(path.encode(), data_offset, pixels, pixels.size)
    return rc == 0
