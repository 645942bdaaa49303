"""The port's phase spans (``utils.logging.span``) in a profiler's trace, on
the CPU: the predictor's "hmmr.encode", "hmmr.window" and "hmmr.smpl", the
trainer's "hmmr.train.forward", ".backward" and ".optimizer" with the
convolutions and "hmmr.smpl" inside the forward; and, with no profiler
running, no ``record_function`` at all and the same outputs bit for bit.

Sizes: a narrow trunk of the ResNet-50 v2 layout (phi 64), 32x32 frames, a
32-vertex synthetic SMPL model; the clip is 10 frames in encoder chunks of
4, the training step 2 tubes of T=8 frames in image mode.
"""

import functools

import numpy as np
import pytest
import torch

from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.infer import HmmrPredictor
from human_dynamics_tpu_torch.models import hmmr as PH
from human_dynamics_tpu_torch.models import resnet as PR
from human_dynamics_tpu_torch.train import trainer as PT
from human_dynamics_tpu_torch.utils.config import Config

torch.set_num_threads(1)

NARROW = ((2, 32, 8), (2, 48, 12), (1, 64, 16))
FRAMES, CHUNK, SIZE = 10, 4, 32
TRAIN = ("hmmr.train.forward", "hmmr.train.backward", "hmmr.train.optimizer")


@pytest.fixture(scope="module", autouse=True)
def narrow_resnet():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PH, "ResNetV2_50",
                   functools.partial(PR.ResNetV2_50, blocks=NARROW))
        yield


@pytest.fixture(scope="module")
def predictor(narrow_resnet):
    model = PH.HmmrModel(include_resnet=True, feature_dim=NARROW[-1][1],
                         generator=torch.Generator().manual_seed(0))
    return HmmrPredictor(model, None, synthetic_smpl_model(32, 25),
                         batch_size=2, encode_chunk=CHUNK,
                         use_fused_smpl=True, device="cpu")


@pytest.fixture(scope="module")
def clip():
    rng = np.random.RandomState(0)
    return rng.randint(0, 256, (FRAMES, SIZE, SIZE, 3)).astype(np.uint8)


def _traced(fn):
    """fn's return and the (name, start, end) of every range and op.

    The autograd profiler that torch.profiler.profile drives, on the CPU
    alone: the same ranges, without torch.profiler's import of
    torch.distributed on its first use (~3 s); its raw events, as
    building ``function_events`` takes ~1 s for a training step."""
    with torch.autograd.profiler.profile() as prof:
        out = fn()
    return out, [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.kineto_results.events()]


def _ranges(events, name):
    return sorted((s, e) for n, s, e in events if n == name)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _convs(events):
    return [(s, e) for n, s, e in events if n == "aten::convolution"]


def test_predictor_phases(predictor, clip):
    _, one_chunk = _traced(lambda: predictor.encode_frames(clip[:CHUNK]))
    per_chunk = len(_convs(one_chunk))
    assert per_chunk > 0
    _, events = _traced(lambda: predictor.predict_all_images(clip))
    (encode,) = _ranges(events, "hmmr.encode")
    (window,) = _ranges(events, "hmmr.window")
    smpl = _ranges(events, "hmmr.smpl")
    assert encode[1] <= window[0]
    # Every encoder chunk's convs inside the encode range.
    inside = [c for c in _convs(events) if _inside(c, encode)]
    assert len(inside) == -(-FRAMES // CHUNK) * per_chunk
    assert smpl and all(_inside(s, window) for s in smpl)


def test_training_phases():
    config = Config(batch_size=2, T=8, img_size=SIZE, precomputed_phi=False,
                    feature_dim=NARROW[-1][1], num_kps=25)
    state = PT.create_train_state(config, "cpu",
                                  torch.Generator().manual_seed(1))
    rng = np.random.RandomState(3)
    b, t = config.batch_size, config.T
    kps = rng.randn(b, t, 25, 3).astype(np.float32)
    kps[..., 2] = 1.0
    arrays = dict(
        phis=rng.uniform(-1, 1, (b, t, SIZE, SIZE, 3)),
        kps=kps,
        poses_gt=rng.randn(b, t, 24, 3) * 0.2,
        shapes_gt=rng.randn(b, 10) * 0.3,
        joints_gt=rng.randn(b, t, 14, 3),
        has_3d_joints=np.ones((b,)),
        has_3d_smpl=np.ones((b,)),
        poses_real=rng.randn(PT.fake_pool_size(config), 24, 3) * 0.2,
    )
    batch = PT.Batch(**{k: torch.from_numpy(np.asarray(v, np.float32))
                        for k, v in arrays.items()})
    _, events = _traced(lambda: PT.train_step(
        config, state, synthetic_smpl_model(32, 25), batch,
        torch.Generator().manual_seed(2)))
    phases = [_ranges(events, name) for name in TRAIN]
    assert all(len(r) == 1 for r in phases), phases
    (forward,), (backward,), (optimizer,) = phases
    assert forward[1] <= backward[0] and backward[1] <= optimizer[0]
    convs = _convs(events)
    assert convs and all(_inside(c, forward) for c in convs)
    assert any(_inside(s, forward) for s in _ranges(events, "hmmr.smpl"))


def test_no_profiler_no_range_and_the_same_outputs(predictor, clip,
                                                   monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counted(name, *args):
        if name.startswith("hmmr."):
            opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    plain = predictor.predict_all_images(clip)
    assert opened == []
    traced, _ = _traced(lambda: predictor.predict_all_images(clip))
    assert {"hmmr.encode", "hmmr.window", "hmmr.smpl"} <= set(opened)
    assert set(traced) == set(plain)
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k], err_msg=k)
