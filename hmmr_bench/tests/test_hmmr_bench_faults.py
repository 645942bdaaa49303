"""Each fault a cell can have, planted under the timed path of a whole run
at a tiny size on the CPU, turns ``correct`` false; the same run without
it is correct. A fault that starts only once set-up's checked steps are
done (``@<step>``) is caught by the stretch checked after the window."""

import pytest

from hmmr_bench.harness import core, faults
from hmmr_bench.tests import tiny
from hmmr_bench.traffic import clip_closed, train_steps

TRAIN_FAULTS = ("state_unchanged", "half_batch")


def _judged(traffic, cell, over, fault=None):
    run = tiny.run(cell, over)
    if fault is None:
        traffic.run(run)
    else:
        with faults.planted(fault):
            traffic.run(run)
    return core.judge(run), run.compared


def test_an_altered_answer_is_caught():
    ok, values = _judged(clip_closed, "serve-clip480-f32", tiny.SERVE, "answer_altered")
    assert not ok, values


@pytest.mark.parametrize("fault", (None,) + TRAIN_FAULTS)
def test_training_faults_are_caught(fault):
    ok, values = _judged(train_steps, "train-image-b8t20", tiny.TRAIN, fault)
    assert ok == (fault is None), values


@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_a_fault_that_starts_after_set_up_is_caught_after_the_window(fault):
    run = tiny.run("train-image-b8t20", tiny.TRAIN)
    late = f"{fault}@{train_steps.STEPS + run.params['warmup_steps']}"
    ok, values = _judged(train_steps, "train-image-b8t20", tiny.TRAIN, late)
    limits = run.limits()
    assert not ok, values
    assert all(values[k] <= limits[k] for k in values if not k.endswith(".last")), values


def test_fault_names():
    assert faults.parse("half_batch") == ("half_batch", 0)
    assert faults.parse("state_unchanged@13") == ("state_unchanged", 13)
    with pytest.raises(ValueError):
        faults.parse("no_such_fault@2")
