"""Build the package's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles ``csrc/forces.cu`` (a plain C interface, no PyTorch
headers, so the build takes seconds) into
``_build/libnbody_kernels_<hash>.so`` inside the package, where the hash
covers the source and the flags: a changed source builds a new library and
an unchanged one is loaded as built.  Nothing here runs at import time, so
the package imports on machines without ``nvcc`` or a GPU; ``load()`` raises
there, with nvcc's own error output when the compile fails.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG_DIR, "csrc", "forces.cu"),)
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# No --use_fast_math (see the note in csrc/forces.cu).  -Xptxas -v makes
# ptxas report registers, shared memory and spills per kernel; the report is
# kept in ``Library.build_log``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Library:
    """The loaded kernel library with its argtypes set."""

    def __init__(self, path: str, build_log: str, build_seconds: float):
        self.path = path
        self.build_log = build_log
        self.build_seconds = build_seconds
        self.cdll = ctypes.CDLL(path)
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        for name in ("nbody_block_forces_f32", "nbody_block_forces_f64"):
            fn = getattr(self.cdll, name)
            # 4 row pointers, m, 4 column pointers, k, row_g0, col_g0,
            # gravity, biased flag pointer, biased default, 2 outputs, stream.
            fn.argtypes = ([vp] * 4 + [i64] + [vp] * 4 + [i64, i64, i64,
                           ctypes.c_double, vp, ctypes.c_int, vp, vp, vp])
            fn.restype = ctypes.c_int
        self.cdll.nbody_cuda_error_string.argtypes = [ctypes.c_int]
        self.cdll.nbody_cuda_error_string.restype = ctypes.c_char_p

    def error_string(self, err: int) -> str:
        return self.cdll.nbody_cuda_error_string(err).decode()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in %s and on PATH): the CUDA kernels of "
            "parallel_nbody_tpu_torch cannot be built" % candidate)
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@functools.cache
def load() -> Library:
    """Build (unless already built from these sources) and load the kernel
    library.  Raises RuntimeError if nvcc is missing or fails."""
    target = os.path.join(BUILD_DIR, "libnbody_kernels_%s.so" % _source_hash())
    if os.path.exists(target):
        return Library(target, "", 0.0)
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build into a temporary name and rename: concurrent first uses never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed (exit %d): %s\n%s%s"
                           % (proc.returncode, " ".join(cmd), proc.stdout,
                              proc.stderr))
    os.replace(tmp, target)
    return Library(target, proc.stdout + proc.stderr, seconds)
