"""Roofline probe P1 on the card: ablations of the fp32 pair loop.

Counterpart of the JAX package's ``benchmarks/roofline_probe.py``.  Each
variant takes part of the force kernel's pair arithmetic out (the rsqrt,
the softening, everything but the loads) and is timed, to locate what
bounds the loop.  The ablated variants compute wrong physics on purpose.
The kernel (``csrc/roofline_probe.cu``) runs each variant on the probes'
own layout (``csrc/probe_layout.cuh``), no longer K1's: four rows per
thread sharing each staged column, the columns split into two parts folded
in rank order inside a thread block cluster.  The loop is bound by
instruction issue (14.375 instructions per pair for ``full``, from
``sass_census``); tensor cores, TMA and Newton's-third-law folding do not
serve it (the source says why).

    python -m parallel_nbody_tpu_torch.benchmarks.roofline_probe [N] [steps]

prints the card's name and power limit, then one line per variant in the
JAX probe's format.  It measures only on a CUDA card and exits 1 without
one.
"""

from __future__ import annotations

import sys

import torch

from . import _probe

VARIANTS = ("full", "no_rsqrt", "no_soften", "mem_only")
NAME = "roofline_probe"


def probe_forces(variant, xi, yi, mi, ri, xj, yj, mj, rj, *, tile_i=256,
                 tile_j=1024):
    """One probe launch: (xf, yf) of the rows (xi, yi, mi, ri) under the
    columns (xj, yj, mj, rj), all fp32 vectors of one length n, a multiple
    of ``tile_i`` and ``tile_j`` (themselves multiples of 128).

    On CUDA tensors it launches the kernel, or raises, and adds one to
    ``probe_forces.launches``; on CPU tensors it runs the plain version in
    the kernel's order (``probe_forces_kernel_order``)."""
    args = (xi, yi, mi, ri, xj, yj, mj, rj)
    _probe.check(NAME, VARIANTS, variant, args, tile_i, tile_j)
    if xi.device.type == "cpu":
        return _probe.kernel_order(variant, args, tile_i, tile_j,
                                   _probe.split_of(variant))
    out = _probe.launch(NAME, "nbody_roofline_probe", VARIANTS.index(variant),
                        args, tile_i, tile_j)
    probe_forces.launches += 1
    return out


probe_forces.launches = 0


def probe_forces_reference(variant, xi, yi, mi, ri, xj, yj, mj, rj, *,
                           tile_i=256, tile_j=1024, magnitudes=False):
    """The plain PyTorch version of ``probe_forces`` on any device: each
    ``tile_j`` column slice summed, the slices folded in order (see
    ``_probe.reference`` for ``magnitudes``)."""
    args = (xi, yi, mi, ri, xj, yj, mj, rj)
    _probe.check(NAME, VARIANTS, variant, args, tile_i, tile_j)
    return _probe.reference(variant, args, tile_i, tile_j, magnitudes)


def probe_forces_kernel_order(variant, xi, yi, mi, ri, xj, yj, mj, rj, *,
                              tile_i=256, tile_j=1024, magnitudes=False):
    """The plain PyTorch version of ``probe_forces`` in the kernel's order,
    on any device: the 128-column tiles cut into ``_probe.SPLIT`` parts,
    each folded in order, the parts folded in rank order (see
    ``_probe.kernel_order``)."""
    args = (xi, yi, mi, ri, xj, yj, mj, rj)
    _probe.check(NAME, VARIANTS, variant, args, tile_i, tile_j)
    return _probe.kernel_order(variant, args, tile_i, tile_j,
                               _probe.split_of(variant), magnitudes)


def bench_variant(variant: str, n: int, steps: int, tile_i: int = 256,
                  tile_j: int = 1024) -> float:
    """Seconds per launch of ``variant`` at ``n`` bodies: one warm run of
    ``steps`` fed-back launches, then one timed run.  Needs a CUDA device."""
    return _probe.bench(probe_forces, variant, n, steps, tile_i, tile_j,
                        repeats=1)


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if not torch.cuda.is_available():
        sys.stderr.write("%s: no CUDA device; the probe measures only on "
                         "the card\n" % NAME)
        return 1
    n, steps = _probe.parse_argv(argv, (65536, 20))
    print(_probe.device_line(), flush=True)
    base = None
    for variant in VARIANTS:
        sec = bench_variant(variant, n, steps)
        rate = n * n / sec
        if base is None:
            base = sec
        print(f"{variant:10s}  {sec*1e3:8.3f} ms/step  {rate:.3e} pairs/s  "
              f"({sec/base*100:5.1f}% of full)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
