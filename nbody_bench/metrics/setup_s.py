"""setup_s: seconds from the process's start to the window's start:
imports, the kernels' build (cached in the checkout after the first run),
the inputs, one warm chunk and, in frame mixes, one warm frame."""


def read(run):
    return run.window.setup_s
