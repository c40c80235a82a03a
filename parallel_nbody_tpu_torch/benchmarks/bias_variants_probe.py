"""Coincident-bias probe P2 on the card: the ways of applying the
reference's coincident-pair kick inside the fp32 pair loop.

Counterpart of the JAX package's ``benchmarks/bias_variants_probe.py``.
The six scalar variants run P1's layout (``csrc/probe_layout.cuh``), no
longer K1's: four rows per thread sharing each staged column, the columns
split into two parts folded in rank order inside a thread block cluster;
their loop is bound by instruction issue (``sass_census``).  The two
tensor-core variants keep one warp per 16 rows and no split.  The variants
(``csrc/bias_variants_probe.cu`` states each one's arithmetic):

  r2          the pair loop without the kick: the bar to recover
  bias2_max   dx + (bj - bi) per pair, floor via max
  bias2_fma   dx + (bj - bi) per pair, floor via + eps
  bias_cond   per tile pair: (bj - bi) on overlapping tiles, a constant
              signed bias elsewhere, floor via + eps
  bias1_const constant bias everywhere (wrong on the diagonal: a lower
              bound for bias_cond)
  bias1_fma   the same arithmetic as bias1_const
  mxu2_r2     r2 with the row sums on the tensor cores (tf32)
  bias1_mxu2  bias1_fma with the row sums on the tensor cores (tf32)

with bi = gi * 2^-50, bj = gj * 2^-50 and the constant 2^-26.

    python -m parallel_nbody_tpu_torch.benchmarks.bias_variants_probe \\
        [N] [steps] [tile_i] [tile_j]

prints the card's name and power limit, then one line per variant in the
JAX probe's format, each the best of 3 timed runs.  It measures only on a
CUDA card and exits 1 without one.
"""

from __future__ import annotations

import sys

import torch

from . import _probe

VARIANTS = ("r2", "bias2_max", "bias2_fma", "bias_cond", "bias1_const",
            "bias1_fma", "mxu2_r2", "bias1_mxu2")
# The tensor-core variants: their terms are rounded to tf32.
TF32_VARIANTS = _probe.TF32_VARIANTS
NAME = "bias_variants_probe"


def probe_forces(variant, xi, yi, mi, ri, xj, yj, mj, rj, *, tile_i=1024,
                 tile_j=1024):
    """One probe launch: (xf, yf) of the rows (xi, yi, mi, ri), global ids
    0..n-1, under the columns (xj, yj, mj, rj), global ids 0..n-1; all fp32
    vectors of one length n, a multiple of ``tile_i`` and ``tile_j``
    (themselves multiples of 128; ``bias_cond`` reads them).

    On CUDA tensors it launches the kernel, or raises, and adds one to
    ``probe_forces.launches``; on CPU tensors it runs the plain version in
    the kernel's order (``probe_forces_kernel_order``)."""
    args = (xi, yi, mi, ri, xj, yj, mj, rj)
    _probe.check(NAME, VARIANTS, variant, args, tile_i, tile_j)
    if xi.device.type == "cpu":
        return _probe.kernel_order(variant, args, tile_i, tile_j,
                                   _probe.split_of(variant))
    out = _probe.launch(NAME, "nbody_bias_variants_probe",
                        VARIANTS.index(variant), args, tile_i, tile_j)
    probe_forces.launches += 1
    return out


probe_forces.launches = 0


def probe_forces_reference(variant, xi, yi, mi, ri, xj, yj, mj, rj, *,
                           tile_i=1024, tile_j=1024, magnitudes=False):
    """The plain PyTorch version of ``probe_forces`` on any device, in fp32
    throughout (the tensor-core variants' terms are not rounded to tf32):
    each ``tile_j`` column slice summed, the slices folded in order (see
    ``_probe.reference`` for ``magnitudes``)."""
    args = (xi, yi, mi, ri, xj, yj, mj, rj)
    _probe.check(NAME, VARIANTS, variant, args, tile_i, tile_j)
    return _probe.reference(variant, args, tile_i, tile_j, magnitudes)


def probe_forces_kernel_order(variant, xi, yi, mi, ri, xj, yj, mj, rj, *,
                              tile_i=1024, tile_j=1024, magnitudes=False):
    """The plain PyTorch version of ``probe_forces`` in the kernel's order,
    on any device, in fp32 throughout: the 128-column tiles cut into
    ``_probe.SPLIT`` parts (one for the tensor-core variants), each folded
    in order, the parts folded in rank order (see
    ``_probe.kernel_order``)."""
    args = (xi, yi, mi, ri, xj, yj, mj, rj)
    _probe.check(NAME, VARIANTS, variant, args, tile_i, tile_j)
    return _probe.kernel_order(variant, args, tile_i, tile_j,
                               _probe.split_of(variant), magnitudes)


def bench_variant(variant: str, n: int, steps: int, tile_i: int,
                  tile_j: int) -> float:
    """Seconds per launch of ``variant`` at ``n`` bodies: one warm run of
    ``steps`` fed-back launches, then the best of 3 timed runs.  Needs a
    CUDA device."""
    return _probe.bench(probe_forces, variant, n, steps, tile_i, tile_j,
                        repeats=3)


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if not torch.cuda.is_available():
        sys.stderr.write("%s: no CUDA device; the probe measures only on "
                         "the card\n" % NAME)
        return 1
    n, steps, tile_i, tile_j = _probe.parse_argv(argv,
                                                 (65536, 20, 1024, 1024))
    print(_probe.device_line(), flush=True)
    base = None
    for variant in VARIANTS:
        sec = bench_variant(variant, n, steps, tile_i, tile_j)
        rate = n * n / sec
        if base is None:
            base = sec
        print(f"{variant:12s}  {sec*1e3:8.3f} ms/step  {rate:.4e} pairs/s  "
              f"({sec/base*100:5.1f}% of r2)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
