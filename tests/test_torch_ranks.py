"""The port's ranks beyond the printout of one run: directory checkpoints
across mesh shapes, ranks that own only padding, torchrun, and
``parallel.dryrun`` (tests/test_torch_distributed.py holds the CLI's ranks
to the JAX CLI).  Split from that file so that the two files' spawned runs
can go to two test workers.

Each multi-process case runs the port in a process group of its own
(``start_new_session``) under a timeout of its own, and kills the group
when the timeout runs out.  Only stdout is compared (the ranks' gloo
messages go to stderr).  Every comparison of printed states is byte for byte (fp64 trig, the parity
configuration).
"""

import socket

import pytest
import torch

from parallel_nbody_tpu_torch import cli
from parallel_nbody_tpu_torch.utils import checkpoint as ckpt
from parallel_nbody_tpu_torch.utils import ppm
from torch_cases import spawned

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


def test_cli_directory_checkpoint_across_mesh_shapes(arena, tmp_path, capsys,
                                                     monkeypatch):
    """60 steps on two all-gather ranks into a directory, then to 100: on a
    1x2 grid (same padded length: each rank loads its shard in place), on
    four ranks (another padded length: loaded whole and re-padded) and on
    one device — each byte-equal to 100 steps uninterrupted."""
    base = ["97", "0", arena]
    ck = str(tmp_path / "ck")
    rc, _, err = _port(base + ["60", "--devices=2", "--checkpoint=" + ck])
    assert rc == 0, err[-3000:]
    meta = ckpt.dcp_metadata(ck)
    assert ckpt.dcp_saved_length(ck, meta) == 98
    _, full, _ = _in_process(cli.main, base + ["100"], capsys, monkeypatch)
    for flags in (["--mesh2d=1x2"], ["--devices=4"]):
        rc, out, err = _port(base + ["100", "--resume=" + ck] + flags)
        assert rc == 0, err[-3000:]
        assert out == full, flags
    rc, out, _ = _in_process(cli.main, base + ["100", "--resume=" + ck],
                             capsys, monkeypatch)
    assert rc == 0 and out == full


@pytest.mark.parametrize("flags", [["--devices=4", "--comm=ring"],
                                   ["--mesh2d=2x2"]], ids=" ".join)
def test_cli_ranks_holding_only_padding(flags, arena, capsys, monkeypatch):
    """More ranks than bodies (tests/test_sharding.py:119-142): N=2 pads to
    4, so two ranks (on the grid a whole row group) own only parked
    padding; the printout is still the single-device run's."""
    argv = ["2", "0", arena, "100"]
    rc, out, err = _port(argv + flags)
    assert rc == 0, err[-3000:]
    _, single, _ = _in_process(cli.main, argv, capsys, monkeypatch)
    assert out == single and len(out.splitlines()) == 2


def test_cli_under_torchrun(arena, capsys, monkeypatch):
    """torchrun starts two ranks that each run the CLI and join its group;
    rank 0 alone prints, and the printout is the single-device run's."""
    argv = ["97", "0", arena, "100", "--devices=2"]
    rc, out, err = spawned(["-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node=2", "-m",
                             "parallel_nbody_tpu_torch.cli"] + argv)
    assert rc == 0, err[-3000:]
    _, single, _ = _in_process(cli.main, argv[:4], capsys, monkeypatch)
    assert out == single


def test_dryrun_two_ranks():
    rc, out, err = spawned(["-m", "parallel_nbody_tpu_torch.parallel.dryrun",
                             "2"])
    assert rc == 0, err[-3000:]
    lines = out.splitlines()
    assert lines[-1] == "MULTIHOST_OK"
    assert lines[0].startswith("dryrun ok: 2 ranks (gloo), comm=allgather+"
                               "ring+grid2d(1x2)")


_GROUP_AFTER_DESTROY = """
import os
import torch.distributed as dist
from parallel_nbody_tpu_torch.parallel import multihost
multihost.initialize("cpu", "localhost:%d", 1, 0)
import torch.distributed.checkpoint
dist.destroy_process_group()
print(sorted(open("/proc/self/task/%%s/comm" %% t).read().strip()
             for t in os.listdir("/proc/self/task")))
"""


def test_group_ends_with_destroy_after_checkpoint_import():
    """A rank that imports torch.distributed.checkpoint after joining (as a
    directory checkpoint does) keeps no gloo thread past
    destroy_process_group: a group left alive is torn down at interpreter
    exit, where it can abort the rank."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    rc, out, err = spawned(["-c", _GROUP_AFTER_DESTROY % port])
    assert rc == 0, err[-3000:]
    assert "gloo" not in out, out
