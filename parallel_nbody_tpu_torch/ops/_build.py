"""Build the package's CUDA kernels at first use and load them with ctypes.

Two libraries, each built on its own so that a compile error in one never
blocks the other, and no source's change or flag reaches the other's build:

- ``load("kernels")`` (the default): everything a step launches,
  ``csrc/forces.cu`` (K1), ``csrc/forces_symmetric.cu`` (the square fp32
  case, each pair once: K1's range in one launch, beyond it in row
  launches), ``csrc/forces_streamed.cu`` (K2),
  ``csrc/forces_trig.cu`` (the parity pass: float64, the reference's
  transcendental pair math) and ``csrc/coincident.cu`` (the coincidence
  flag, a hash-table duplicate test), into
  ``_build/libnbody_kernels_<hash>.so``;
- ``load("probes")``: the roofline and coincident-bias probes,
  ``csrc/roofline_probe.cu`` (P1) and ``csrc/bias_variants_probe.cu`` (P2),
  into ``_build/libnbody_probes_<hash>.so``.

``nvcc`` compiles each source of a library to its own object, all of them at
once, and links the objects without device LTO, so a kernel's SASS depends on
its own source and headers alone.  The sources have a plain C interface and
no PyTorch headers, so a build takes seconds.  A library's hash covers its
sources, the headers they include and the flags: a changed source builds a
new library and an unchanged one is loaded as built.  Nothing here runs at
import time, so the package imports on machines without ``nvcc`` or a GPU;
``load()`` raises there, with nvcc's own error output when a compile fails.
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
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# No --use_fast_math (see the note in csrc/pairs.cuh).  -Xptxas -v makes
# ptxas report registers, shared memory and spills per kernel; the report is
# kept in ``Library.build_log``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# Argtypes of the force kernels' launchers; each stem exists for f32, f64
# and bf16 (name stem_suffix).
_KERNEL_STEMS = {
    # 4 row pointers, m, 4 column pointers, k, row_g0, col_g0, gravity,
    # biased flag pointer, biased default, compensated, 2 outputs, stream.
    "nbody_block_forces": ([_VP] * 4 + [_I64] + [_VP] * 4
                           + [_I64, _I64, _I64, ctypes.c_double, _VP, _INT,
                              _INT, _VP, _VP, _VP]),
    # 3 row pointers (x, y, r), m, 4 column pointers, k, band, row_g0,
    # col_g0, biased flag pointer, biased default, compensated, workspace,
    # stream.
    "nbody_band_partials": ([_VP] * 3 + [_I64] + [_VP] * 4
                            + [_I64, _I64, _I64, _I64, _VP, _INT, _INT, _VP,
                               _VP]),
    # workspace, bands, m, row masses, gravity, compensated, 2 outputs,
    # stream.
    "nbody_band_fold": [_VP, _I64, _I64, _VP, ctypes.c_double, _INT, _VP,
                        _VP, _VP],
}
DTYPE_SUFFIXES = ("f32", "f64", "bf16")
# The symmetric kernel's launchers, for the storage types that compute in
# fp32: 4 pointers (x, y, mass, radius), n, tile, biased flag pointer,
# biased default, workspace, stream.
_SYMMETRIC_STEM = "nbody_block_forces_symmetric"
_SYMMETRIC_ARGTYPES = [_VP] * 4 + [_I64, _I64, _VP, _INT, _VP, _VP]
# Its row launches: 4 pointers, n, tile, first and end row tile, biased
# flag pointer, biased default, the two workspaces, stream; and their fold:
# the two workspaces, n, tile, first and end row tile, the running sums,
# masses, gravity, 2 outputs, stream.
_SYMMETRIC_ROW_STEMS = {
    "nbody_symmetric_rows": [_VP] * 4 + [_I64] * 4 + [_VP, _INT, _VP, _VP,
                                                      _VP],
    "nbody_symmetric_fold": [_VP, _VP] + [_I64] * 4 + [
        _VP, _VP, ctypes.c_double, _VP, _VP, _VP],
}
# The probes' launchers: variant, 8 input pointers (xi, yi, mi, ri, xj, yj,
# mj, rj), n, tile_i, tile_j, 2 outputs, stream.
_PROBE_ARGTYPES = [_INT] + [_VP] * 8 + [_I64] * 3 + [_VP] * 3

# The parity pass's launcher: 4 pointers (x, y, mass, radius), n, gravity,
# 2 outputs, stream.
_TRIG_ARGTYPES = [_VP] * 4 + [_I64, ctypes.c_double, _VP, _VP, _VP]

# The coincidence flag's launchers, one per storage type: 3 pointers (x, y,
# mass), n, the table, its slots, the flag, stream.
_COINCIDENT_STEM = "nbody_any_coincident"
_COINCIDENT_ARGTYPES = [_VP] * 3 + [_I64, _VP, _I64, _VP, _VP]

# library name -> (sources in csrc/, the headers in csrc/ that they include,
# {function name: argtypes}).
LIBRARIES = {
    "kernels": (("forces.cu", "forces_symmetric.cu", "forces_streamed.cu",
                 "forces_trig.cu", "coincident.cu"),
                ("pairs.cuh",),
                {**{"%s_%s" % (stem, suffix): argtypes
                    for stem, argtypes in _KERNEL_STEMS.items()
                    for suffix in DTYPE_SUFFIXES},
                 **{"%s_%s" % (_SYMMETRIC_STEM, suffix): _SYMMETRIC_ARGTYPES
                    for suffix in ("f32", "bf16")},
                 **{"%s_%s" % (stem, suffix): argtypes
                    for stem, argtypes in _SYMMETRIC_ROW_STEMS.items()
                    for suffix in ("f32", "bf16")},
                 "nbody_trig_forces_f64": _TRIG_ARGTYPES,
                 **{"%s_%s" % (_COINCIDENT_STEM, suffix): _COINCIDENT_ARGTYPES
                    for suffix in DTYPE_SUFFIXES}}),
    "probes": (("roofline_probe.cu", "bias_variants_probe.cu"),
               ("probe_layout.cuh", "pairs.cuh"),
               {"nbody_roofline_probe": _PROBE_ARGTYPES,
                "nbody_bias_variants_probe": _PROBE_ARGTYPES}),
}


class Library:
    """The loaded kernel library with its argtypes set."""

    def __init__(self, path: str, build_log: str, build_seconds: float,
                 signatures):
        self.path = path
        self.build_log = build_log
        self.build_seconds = build_seconds
        self.cdll = ctypes.CDLL(path)
        for name, argtypes in signatures.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        # Every library defines the error-string function once.
        self.cdll.nbody_cuda_error_string.argtypes = [ctypes.c_int]
        self.cdll.nbody_cuda_error_string.restype = ctypes.c_char_p

    def fn(self, stem: str, suffix: str):
        return getattr(self.cdll, "%s_%s" % (stem, suffix))

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


def _library_hash(name: str) -> str:
    """The hash of the flags and of library ``name``'s sources and headers,
    names and contents."""
    files, headers, _ = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files + headers:
        h.update(f.encode())
        with open(os.path.join(_CSRC, f), "rb") as src:
            h.update(src.read())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once; wait for all.  Returns the failures as
    (cmd, returncode, output) and the combined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed, log = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append((cmd, proc.returncode, out))
    return failed, "".join(log)


@functools.cache
def load(name: str = "kernels") -> Library:
    """Build (unless already built from these sources) and load the library
    ``name`` of ``LIBRARIES``.  Raises RuntimeError if nvcc is missing or
    fails."""
    files, _, signatures = LIBRARIES[name]
    sources = [os.path.join(_CSRC, f) for f in files]
    target = os.path.join(BUILD_DIR, "libnbody_%s_%s.so"
                          % (name, _library_hash(name)))
    if os.path.exists(target):
        return Library(target, "", 0.0, signatures)
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build in a private directory and rename the library into place:
    # concurrent first uses never load a half-written library.
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(work, os.path.basename(src) + ".o")
                for src in sources]
        t0 = time.perf_counter()
        failed, log = _run_all(
            [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
             for obj, src in zip(objs, sources)])
        if not failed:
            lib = os.path.join(work, "lib.so")
            failed, link_log = _run_all(
                [[nvcc, "-shared", "-o", lib, *objs]])
            log += link_log
        seconds = time.perf_counter() - t0
        if failed:
            cmd, rc, out = failed[0]
            raise RuntimeError("nvcc failed (exit %d): %s\n%s"
                               % (rc, " ".join(cmd), out))
        os.replace(lib, target)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return Library(target, log, seconds, signatures)
