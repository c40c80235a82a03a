"""The port's distributed programs run as real gloo ranks on the CPU: the
CLI spawning its ranks (``--devices=K``, ``--comm=ring``, ``--mesh2d``)
against the JAX CLI on the same argv and against the golden fixture, and
the parallel CSV row (tests/test_torch_ranks.py has the rest).

Each multi-process case runs the port in a process group of its own
(``start_new_session``) under a timeout of its own, and kills the group
when the timeout runs out.  Only stdout is compared (the ranks' gloo
messages go to stderr).  The JAX CLI runs in this process on the same argv,
sharded over the 8 virtual devices of tests/conftest.py.  Every
comparison of printed states is byte for byte (fp64 trig, the parity
configuration).
"""

import os
import re

import pytest
import torch

import parallel_nbody_tpu.cli as jcli
from parallel_nbody_tpu_torch import cli
from parallel_nbody_tpu_torch.utils import ppm
from torch_cases import REPO, spawned

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("arena") / "nbody.ppm")
    ppm.create(p, 1024, 768)
    return p


def _port(argv):
    return spawned(["-m", "parallel_nbody_tpu_torch.cli"] + argv)


def _in_process(main, argv, capsys, monkeypatch):
    monkeypatch.setenv("NBODY_PLATFORM", "cpu")
    capsys.readouterr()
    rc = main(["nbody"] + argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("flags", [["--devices=2"],
                                   ["--devices=4", "--comm=ring"],
                                   ["--mesh2d=2x2"], ["--mesh2d=1x2"]],
                         ids=" ".join)
def test_cli_ranks_byte_equal_to_jax(flags, arena, capsys, monkeypatch):
    """N=97 (prime, so every rank count pads), 100 steps: the printout of
    the port's ranks equals the JAX CLI's on the same argv and the port's
    single-device run."""
    argv = ["97", "0", arena, "100"]
    rc, out, err = _port(argv + flags)
    assert rc == 0, err[-3000:]
    assert "Running N-body with 97 bodies and 100 steps" in err
    jrc, jout, _ = _in_process(jcli.main, argv + flags, capsys, monkeypatch)
    _, single, _ = _in_process(cli.main, argv, capsys, monkeypatch)
    assert jrc == 0 and len(out.splitlines()) == 97
    assert out == jout == single


def test_cli_ranks_match_golden_fixture(arena):
    """The reference's own printout for N=128 after 1000 steps, from four
    all-gather ranks."""
    rc, out, err = _port(["128", "0", arena, "1000", "--devices=4"])
    assert rc == 0, err[-3000:]
    with open(os.path.join(REPO, "tests", "fixtures",
                           "128_MY_REF_OUTPUT")) as f:
        assert out == f.read()


@pytest.mark.parametrize("flags, precise", [
    (["--devices=4", "--comm=ring", "--xps-precise"], True),
    (["--mesh2d=2x2"], False)], ids=["ring-precise", "grid2d"])
def test_cli_ranks_xps_row(flags, precise, arena, capsys, monkeypatch):
    """--run-xps --measure-comm: the parallel row, whose integer fields
    (SIZE, NODES, CPUS_PER_NODE, NBODIES) are the JAX CLI's — ranks spawned
    by one command are one node — with COMMTIME measured."""
    argv = ["97", "0", arena, "20", "--run-xps", "--measure-comm"] + flags
    rc, out, err = _port(argv)
    assert rc == 0, err[-3000:]
    _, jout, _ = _in_process(jcli.main, argv, capsys, monkeypatch)
    dec = r"\d+\.\d{6}" if precise else r"\d+\.\d{3}"
    pattern = r"(\d+,\d+,\d+,\d+),\d+\.\d{3},(%s),(%s),\d+\.\d{2}\n" % (dec,
                                                                        dec)
    row, jrow = re.fullmatch(pattern, out), re.fullmatch(pattern, jout)
    assert row is not None and jrow is not None, (out, jout)
    assert row.group(1) == jrow.group(1) == "4,1,4,97"
    if precise:
        assert float(row.group(2)) > 0
