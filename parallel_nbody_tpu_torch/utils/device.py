"""The device a tool runs on: the CUDA card unless the caller asks for the
CPU.

The tools of the port (``benchmarks.hw_validate``, ``benchmarks.drift_study``,
``examples.animate``, ``entry``) measure or record what the card computes,
so finding no card is an error, never a silent fall-back to the CPU.  The
CPU is used only when asked for: ``--device=cpu`` on a command line,
``device="cpu"`` from Python.
"""

from __future__ import annotations

import sys

import torch

DEVICES = ("cpu", "cuda")


def resolve(requested: str | torch.device | None = None) -> torch.device:
    """The device for ``requested`` ("cpu", "cuda", a ``torch.device``, or
    None for the card).  Raises RuntimeError when the card is wanted and
    there is none, ValueError on any other name."""
    try:
        device = torch.device("cuda" if requested is None else requested)
    except RuntimeError as e:
        raise ValueError("unsupported device %r (expected cpu or cuda)"
                         % (requested,)) from e
    if device.type not in DEVICES:
        raise ValueError("unsupported device %r (expected cpu or cuda)"
                         % (requested,))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (the device is the "
                           "card unless --device=cpu or device=\"cpu\" asks "
                           "for the CPU)")
    return device


def split_flags(argv, names):
    """(positional arguments, {name: value}) of ``argv`` (program name
    first), taking ``--name=value`` for each of ``names`` out of it.
    Raises ValueError on any other ``--`` flag."""
    args, flags = [], {}
    for a in argv:
        key, eq, value = a.partition("=")
        if a.startswith("--") and eq and key[2:] in names:
            flags[key[2:]] = value
        elif a.startswith("--"):
            raise ValueError("unknown flag %r (expected %s)" % (
                a, ", ".join("--%s=..." % n for n in names)))
        else:
            args.append(a)
    return args, flags


def tool_argv(tool: str, argv, names=("device", "out")):
    """(positional arguments, flags, device) of a tool's argv (program name
    first; ``--name=value`` for each of ``names``), or None after writing
    ``tool: why`` to stderr: an unknown flag, an unknown device, or no card
    when the CPU was not asked for."""
    try:
        args, flags = split_flags(argv[1:], names)
        return args, flags, resolve(flags.get("device"))
    except (RuntimeError, ValueError) as e:
        sys.stderr.write("%s: %s\n" % (tool, e))
        return None
