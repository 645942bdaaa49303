"""On the card, at the cells' own sizes: the program's compared numbers sit
within the cells' limits and the control's (the reference one precision
down in the program's place) outside them, as the readings that set the
limits showed. Skips without a card:

    python -m pytest hmmr_bench/tests/test_hmmr_bench_card.py -m cuda
"""

import pytest

from hmmr_bench.harness import core

SEED = 2_147_483_733


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve-clip480-f32", "train-image-b8t20"])
def test_program_within_and_control_outside_the_limits(cell, cuda_device):
    run = core.Run(cell, SEED, 1.0, False)
    run.device = cuda_device
    traffic = core.load_module("traffic", run.mix["kind"])
    traffic.run(run)
    assert core.judge(run), run.compared
    low = traffic.control(run)
    limits = run.limits()
    assert any(v > limits[k] for k, v in low.items()), low
