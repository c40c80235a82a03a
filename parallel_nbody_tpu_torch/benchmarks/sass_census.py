"""Instruction census of the kernels' pair loops, read from the SASS of a
built library (``cuobjdump -sass``).

    python -m parallel_nbody_tpu_torch.benchmarks.sass_census [kernels|probes]

builds the library at first use (``ops/_build.py``) and prints one line per
inner loop of each kernel: a loop that ends in a backward branch, reads
shared memory and holds no barrier, i.e. the sweep over a staged column
tile.  The line gives the loop's instructions per pair and their mix.  Each
SM sub-partition issues one warp instruction per clock, and the FP32 pipe
takes one FP32 instruction per clock from each, so a pair loop whose
instructions are nearly all FP32 is bound by instruction issue: its time
goes as its instructions per pair, whatever their unit.  It needs
``cuobjdump`` (CUDA toolkit), not a card.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

from ..ops import _build

# Pairs one pass of each kernel's inner loop covers: the row kernels unroll
# the tile loop 8 times; a lane of the tensor-core kernel computes 4 pairs
# for each of the 4 unrolled 8-column chunks.
_PAIRS = {"bias_probe_mma_kernel": 16}
_DEFAULT_PAIRS = 8
# Opcodes of the FP32 pipe, counted together.
FP32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL")
_LDS_FLOATS = {"LDS": 1, "LDS.64": 2, "LDS.128": 4}

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
# A kernel's name follows its length in the mangled symbol.
_KERNEL = re.compile(r"\d+([a-z_]+_kernel)I(\w+?)EE")


def kernel_name(mangled: str) -> str:
    """A short name for a mangled kernel symbol: its template with the
    arguments as mangled, e.g. ``roofline_probe_kernel<Li0>`` or
    ``block_forces_kernel<fLb0>``."""
    m = _KERNEL.search(mangled)
    return "%s<%s>" % m.groups() if m else mangled


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
    no barrier, as Counters of opcodes, in address order."""
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
    return sorted(loops)


def census(sass: str):
    """[(kernel, start, end, pairs per pass, Counter)] for every inner loop
    of every kernel in the listing."""
    rows = []
    for mangled, instrs in functions(sass).items():
        name = kernel_name(mangled)
        pairs = next((p for k, p in _PAIRS.items() if name.startswith(k)),
                     _DEFAULT_PAIRS)
        for start, end, ops in inner_loops(instrs):
            rows.append((name, start, end, pairs, ops))
    return rows


def floats_loaded(ops) -> int:
    """Shared-memory floats one pass of a loop reads."""
    return sum(_LDS_FLOATS.get(op, 0) * n for op, n in ops.items())


def format_row(row) -> str:
    name, start, end, pairs, ops = row
    total = sum(ops.values())
    fp32 = sum(ops[op] for op in FP32)
    return ("%-34s loop %5x-%5x  %6.3f instr/pair: FP32 %6.3f, MUFU %5.3f, "
            "HMMA %5.3f, shared floats %5.3f, other %6.3f"
            % (name, start, end, total / pairs, fp32 / pairs,
               ops["MUFU"] / pairs, ops["HMMA"] / pairs,
               floats_loaded(ops) / pairs,
               (total - fp32 - ops["MUFU"] - ops["HMMA"]
                - sum(n for op, n in ops.items() if op.startswith("LDS")))
               / pairs))


def cuobjdump() -> str:
    """The toolkit's cuobjdump, next to nvcc."""
    found = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return found if os.path.exists(found) else shutil.which("cuobjdump")


def library_sass(name: str) -> str:
    """The SASS listing of library ``name`` (built at first use)."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found next to nvcc or on PATH")
    return subprocess.run([tool, "-sass", _build.load(name).path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    for name in argv[1:] or ("kernels", "probes"):
        for row in census(library_sass(name)):
            print(format_row(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
