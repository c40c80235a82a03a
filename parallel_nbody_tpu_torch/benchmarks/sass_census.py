"""Instruction census of the kernels' pair loops, read from the SASS of a
built library (``cuobjdump -sass``).

    python -m parallel_nbody_tpu_torch.benchmarks.sass_census [kernels|probes|trig]

builds the library at first use (``ops/_build.py``) and prints one line per
inner loop of each kernel: a loop that ends in a backward branch, reads
shared memory, holds no barrier and no other such loop, i.e. the sweep over
a staged column tile.  The line gives the loop's instructions per pair and
their mix, and for the force kernels K1 and K2 which of their three pair
loops it is (``loop_roles``).  The symmetric kernel (K1's square fp32 case,
csrc/forces_symmetric.cu) has two loops that evaluate each unordered pair
once, for both bodies (the ones with shuffles: unbiased and constant bias),
whose counts are per unordered pair, and K1's three loops on its diagonal
tiles.  The parity pass (csrc/forces_trig.cu, library ``trig``) has one
loop, a pass of which evaluates one ordered pair a thread in float64 and
adds its group's terms; its out-of-line slow paths (the argument reduction
of huge angles, a division's special cases) lie inside the loop's address
range too, so its count is an upper bound of the path that runs.  Each SM
sub-partition issues one warp instruction per
clock, and the FP32 pipe takes one FP32 instruction per clock from each, so
a pair loop whose instructions are nearly all FP32 is bound by instruction
issue: its time goes as its instructions per pair, whatever their unit.
The FP64 pipe takes a warp's FP64 instruction in two clocks (16 lanes), so
the parity loop's bound is the larger of its instructions and twice its
FP64 instructions.  It needs ``cuobjdump`` (CUDA toolkit), not a card.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

from ..ops import _build
from . import _probe
from . import bias_variants_probe as p2
from . import roofline_probe as p1

# Pairs one pass of each kernel's inner loop covers: the force kernels
# unroll the tile loop 8 times (one row per thread); the probes' row
# kernels unroll it 8 columns deep over their R rows per thread, R being
# the last template argument (``roofline_probe_kernel<Li0ELi4>``, see
# ``probe_kernel_name``); a lane of the tensor-core kernel computes 4 pairs
# for each of the 4 unrolled 8-column chunks.
_UNROLL = 8
_MMA_PAIRS = 16
# The symmetric kernel's pass off the diagonal: kSub columns by kRows rows
# a thread (csrc/forces_symmetric.cu).
SYMMETRIC_COLUMNS, SYMMETRIC_ROWS = 8, 8
_PROBE_ROW_KERNEL = re.compile(
    r"(roofline_probe_kernel|bias_probe_kernel)<Li(\d+)ELi(\d+)>")
# probe NAME -> (its module, its row kernel's template).
_PROBE_ROW_KERNELS = {p1.NAME: (p1, "roofline_probe_kernel"),
                      p2.NAME: (p2, "bias_probe_kernel")}
# Opcodes of the FP32 pipe, counted together, and of the FP64 pipe.
FP32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL")
FP64 = ("DADD", "DMUL", "DFMA", "DMNMX", "DSETP")
_LDS_FLOATS = {"LDS": 1, "LDS.64": 2, "LDS.128": 4}

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
# A kernel's name follows its length in the mangled symbol.
_KERNEL = re.compile(r"\d+([a-z_]+_kernel)I(\w+?)EE")
# The force kernels: each instantiation holds three pair loops
# (csrc/pairs.cuh::sweep_segment), one per kind of dx bias.
FORCE_KERNELS = ("block_forces_kernel", "band_partials_kernel")
ROLES = ("unbiased", "constant bias", "per-pair bias")
SYMMETRIC_KERNEL = "block_forces_symmetric_kernel"
SYMMETRIC_ROLES = ("symmetric unbiased", "symmetric constant bias")
TRIG_KERNEL = "trig_forces_kernel"


def kernel_name(mangled: str) -> str:
    """A short name for a mangled kernel symbol: its template with the
    arguments as mangled, e.g. ``roofline_probe_kernel<Li0>`` or
    ``block_forces_kernel<fLb0>``."""
    m = _KERNEL.search(mangled)
    return "%s<%s>" % m.groups() if m else mangled


def probe_kernel_name(probe: str, variant: str) -> str:
    """The ``kernel_name`` of the kernel that ``variant`` of ``probe`` (a
    probe module's NAME) launches: a row kernel templated on the variant's
    index and the rows per thread (``_probe.ROWS``), e.g.
    ``roofline_probe_kernel<Li0ELi4>``, or the tensor-core kernel,
    ``bias_probe_mma_kernel<Lb1>`` for ``bias1_mxu2``."""
    if variant in _probe.TF32_VARIANTS:
        return "bias_probe_mma_kernel<Lb%d>" % (variant == "bias1_mxu2")
    module, template = _PROBE_ROW_KERNELS[probe]
    return "%s<Li%dELi%d>" % (template, module.VARIANTS.index(variant),
                              _probe.ROWS)


def functions(sass: str):
    """{mangled name: [(address, instruction text)]} of a cuobjdump -sass
    listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        f = _FUNCTION.search(line)
        if f:
            cur = out.setdefault(f.group(1), [])
        elif cur is not None:
            m = _INSTR.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2)))
    return out


def _opcode(text: str) -> str:
    """The opcode with its width suffix for LDS, without a predicate."""
    op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
    return op if op.startswith("LDS") else op.split(".")[0]


def inner_loops(instrs):
    """The bodies of the backward branches that read shared memory and hold
    no barrier and no other such loop, as Counters of opcodes, in address
    order."""
    index = {a: k for k, (a, _) in enumerate(instrs)}
    loops = []
    for k, (addr, text) in enumerate(instrs):
        if _opcode(text) != "BRA":
            continue
        target = re.search(r"0x([0-9a-f]+)", text.split("BRA", 1)[1])
        if target is None:
            continue
        start = int(target.group(1), 16)
        if start >= addr or start not in index:
            continue
        ops = collections.Counter(_opcode(t)
                                  for _, t in instrs[index[start]:k + 1])
        if any(op.startswith("LDS") for op in ops) and "BAR" not in ops:
            loops.append((start, addr, ops))
    return sorted(loop for loop in loops
                  if not any(loop[0] <= other[0] and other[1] <= loop[1]
                             and other != loop for other in loops))


def pairs_per_pass(name: str, ops=None) -> int:
    """Pairs one pass of kernel ``name``'s inner loop covers (``ops``, the
    loop's Counter, tells the symmetric kernel's loops apart)."""
    if name.startswith("bias_probe_mma_kernel"):
        return _MMA_PAIRS
    if name.startswith(SYMMETRIC_KERNEL) and ops and ops["SHFL"]:
        return SYMMETRIC_COLUMNS * SYMMETRIC_ROWS
    if name.startswith(TRIG_KERNEL):
        return 1
    m = _PROBE_ROW_KERNEL.fullmatch(name)
    return _UNROLL * (int(m.group(3)) if m else 1)


def census(sass: str):
    """[(kernel, start, end, pairs per pass, Counter)] for every inner loop
    of every kernel in the listing."""
    rows = []
    for mangled, instrs in functions(sass).items():
        name = kernel_name(mangled)
        for start, end, ops in inner_loops(instrs):
            rows.append((name, start, end, pairs_per_pass(name, ops), ops))
    return rows


def loop_roles(rows):
    """{(kernel, loop start): role} for the pair loops of the force kernels
    in census rows.  The per-pair loop is the one that converts the index
    difference to a float (I2F); of the other two the constant-bias loop
    has one FADD per pair more than the unbiased one, so it is the longer.
    The symmetric kernel's loops with shuffles get SYMMETRIC_ROLES, the
    shorter one unbiased; its other three are K1's.  The parity pass's one
    loop is ``trig``.  A kernel whose loops do not fit that pattern gets no
    roles."""
    loops = collections.defaultdict(list)
    symmetric = collections.defaultdict(list)
    trig = collections.defaultdict(list)
    for name, start, _, _, ops in rows:
        if name.startswith(TRIG_KERNEL):
            trig[name].append(start)
        elif name.startswith(SYMMETRIC_KERNEL) and ops["SHFL"]:
            symmetric[name].append((sum(ops.values()), start))
        elif name.startswith(FORCE_KERNELS + (SYMMETRIC_KERNEL,)):
            loops[name].append((start, ops))
    roles = {(name, found[0]): "trig" for name, found in trig.items()
             if len(found) == 1}
    for name, found in symmetric.items():
        if len(found) == 2 and found[0][0] != found[1][0]:
            for (_, start), role in zip(sorted(found), SYMMETRIC_ROLES):
                roles[name, start] = role
    for name, found in loops.items():
        conv = [s for s, ops in found
                if any(op.startswith("I2F") for op in ops)]
        rest = sorted((sum(ops.values()), s) for s, ops in found
                      if s not in conv)
        if len(conv) != 1 or len(rest) != 2 or rest[0][0] == rest[1][0]:
            continue
        for start, role in zip((rest[0][1], rest[1][1], conv[0]), ROLES):
            roles[name, start] = role
    return roles


def ptxas_registers(log: str):
    """{kernel: (registers, spill store bytes)} from the ``-Xptxas -v``
    report in a build log (``Library.build_log``), kernels named as
    ``kernel_name`` names them."""
    out, cur = {}, None
    for line in log.splitlines():
        f = re.search(r"Compiling entry function '(\S+)'", line)
        if f:
            cur = kernel_name(f.group(1))
            out[cur] = (0, 0)
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            out[cur] = (out[cur][0], int(spill.group(1)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[cur] = (int(regs.group(1)), out[cur][1])
    return out


def floats_loaded(ops) -> int:
    """Shared-memory floats one pass of a loop reads."""
    return sum(_LDS_FLOATS.get(op, 0) * n for op, n in ops.items())


def probe_loop_faults(row):
    """What is wrong with one pair loop of a probe kernel (census row), as
    a list of strings; [] when nothing is, or the loop is no probe's.  No
    probe loop may hold rsqrtf's wrapper for tiny arguments (an FSETP and
    two predicated FMULs a pair; the probes use the bare MUFU): a row
    kernel's loop holds no FSETP at all, the tensor-core kernel's no more
    than its two tf32 conversions a pair bring (one each on sm_90).  A row
    kernel's pass must cover 8 columns of its R rows, one MUFU per pair
    where the variant takes an rsqrt (all but P1's no_rsqrt and mem_only),
    and read each of its 8 columns once in full: 4 shared floats a column
    (x, y, m, r), 3 for P1's no_soften, which has no use for r.  Fewer
    floats than that means the compiler dropped a load the variant is
    meant to keep."""
    name, _, _, pairs, ops = row
    m = _PROBE_ROW_KERNEL.fullmatch(name)
    if m is None:
        mma = name.startswith("bias_probe_mma_kernel")
        return (["%d FSETP for %d pairs" % (ops["FSETP"], pairs)]
                if mma and ops["FSETP"] > 2 * pairs else [])
    faults = ["%d FSETP" % ops["FSETP"]] if ops["FSETP"] else []
    kernel, variant = m.group(1), int(m.group(2))
    p1 = kernel == "roofline_probe_kernel"
    rsqrt = not (p1 and variant in (1, 3))
    if rsqrt and ops["MUFU"] != pairs:
        faults.append("%d MUFU for %d pairs" % (ops["MUFU"], pairs))
    need = (3 if p1 and variant == 2 else 4) * _UNROLL
    if floats_loaded(ops) < need:
        faults.append("%d shared floats for %d columns (dropped loads)"
                      % (floats_loaded(ops), _UNROLL))
    return faults


def instr_per_pair(row) -> float:
    """Instructions per pair of one census row."""
    return sum(row[4].values()) / row[3]


def fp64_per_pair(row) -> float:
    """FP64-pipe instructions per pair of one census row."""
    return sum(row[4][op] for op in FP64) / row[3]


def issue_cycles_per_pair(row) -> float:
    """A sub-partition's clocks per warp pass of one census row, per pair
    of a thread: its instructions, or twice its FP64 instructions where the
    FP64 pipe is the tighter limit."""
    return max(instr_per_pair(row), 2 * fp64_per_pair(row))


def format_row(row, role: str = "") -> str:
    name, start, end, pairs, ops = row
    total = sum(ops.values())
    fp32 = sum(ops[op] for op in FP32)
    fp64 = sum(ops[op] for op in FP64)
    return ("%-34s %-13s loop %5x-%5x  %6.3f instr/pair: FP32 %6.3f, %sMUFU "
            "%5.3f, HMMA %5.3f, shared floats %5.3f, other %6.3f"
            % (name, role, start, end, total / pairs, fp32 / pairs,
               "FP64 %6.3f, " % (fp64 / pairs) if fp64 else "",
               ops["MUFU"] / pairs, ops["HMMA"] / pairs,
               floats_loaded(ops) / pairs,
               (total - fp32 - fp64 - ops["MUFU"] - ops["HMMA"]
                - sum(n for op, n in ops.items() if op.startswith("LDS")))
               / pairs))


def cuobjdump() -> str:
    """The toolkit's cuobjdump, next to nvcc."""
    found = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return found if os.path.exists(found) else shutil.which("cuobjdump")


def sass_of(path: str) -> str:
    """The SASS listing of the built library at ``path``."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found next to nvcc or on PATH")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def library_sass(name: str) -> str:
    """The SASS listing of library ``name`` (built at first use)."""
    return sass_of(_build.load(name).path)


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    for name in argv[1:] or ("kernels", "probes", "trig"):
        rows = census(library_sass(name))
        roles = loop_roles(rows)
        for row in rows:
            print(format_row(row, roles.get((row[0], row[1]), "")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
