"""On the card, at each cell's own size: the program's run is correct and
the bfloat16 control, judged by the same limits, is not, on three seeds.
Skips without a card.

    python -m pytest -p no:cacheprovider -m gpu nbody_bench/tests
"""

import pytest
import torch

from conftest import MANIFEST

from nbody_bench import calibrate, harness

CELLS = ["k1_64k_glibc", "k2_1m_uniform", "k1_64k_frames",
         "k1_64k_uniform"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
@pytest.mark.parametrize("workload", CELLS)
def test_program_correct_and_control_fails(card, workload, seed):
    cell = harness.load_cell(MANIFEST, workload)
    out = harness.run(cell, seed, 1.0, False, card,
                      control=calibrate.bf16_control)
    assert out["correct"], out["checks"]
    assert out["control_correct"] is False, out["control"]
