"""The plain reference against the port, at tiny sizes on the CPU: the
parameter layout, SMPL, the fp32 ResNet, and whole runs of the serving and
training traffic, whose compared numbers must sit far inside the cells'
limits while the controls' sit far outside."""

import pytest
import torch

from hmmr_bench.harness import core, inputs
from hmmr_bench.reference import model as M
from hmmr_bench.reference import smpl as ref_smpl
from hmmr_bench.tests import tiny
from hmmr_bench.traffic import clip_closed, train_steps


@pytest.mark.parametrize("feature,resnet", [(2048, True), (64, False)])
def test_specs_are_the_ports_state_dicts(feature, resnet):
    from human_dynamics_tpu_torch.models.discriminator import PoseDiscriminator
    from human_dynamics_tpu_torch.models.hmmr import HmmrModel

    port = HmmrModel(include_resnet=resnet, feature_dim=feature, device="meta")
    want = [(k, tuple(v.shape)) for k, v in port.state_dict().items()]
    assert sorted((n, s) for n, s, _ in M.hmmr_specs(feature, resnet)) == sorted(want)
    disc = PoseDiscriminator(device="meta").state_dict()
    assert sorted((n, s) for n, s, _ in M.disc_specs()) == sorted(
        (k, tuple(v.shape)) for k, v in disc.items())


def test_smpl_and_resnet_match_the_port():
    from human_dynamics_tpu_torch.core.smpl import SmplModel, smpl_forward
    from human_dynamics_tpu_torch.models.resnet import ResNetV2_50

    arrays = inputs.smpl_arrays(3, 300, 25, "cpu")
    g = torch.Generator().manual_seed(0)
    beta, theta = torch.randn(6, 10, generator=g), torch.randn(6, 72, generator=g) * 0.4
    got = smpl_forward(SmplModel(**arrays), beta, theta)
    verts, joints, rots = ref_smpl.smpl(arrays, beta, theta)
    torch.testing.assert_close(verts, got.verts, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(joints, got.joints, atol=1e-5, rtol=1e-5)

    params = inputs.make_params(M.resnet_specs(), 4, "cpu")
    net = ResNetV2_50(device="cpu")
    net.load_state_dict({k[len(M.R):]: v for k, v in params.items()})
    x = torch.rand(2, 32, 32, 3, generator=g) * 2 - 1
    for train in (False, True):
        torch.testing.assert_close(M.resnet(params, x, train), net(x, train=train),
                                   atol=2e-5, rtol=2e-5)


def test_serving_reference_follows_the_port_and_the_control_does_not():
    run = tiny.run("serve-clip480-f32", tiny.SERVE)
    clip_closed.run(run)
    limits = run.limits()
    assert core.judge(run), run.compared
    assert all(v <= limits[k] / 10 for k, v in run.compared.items()), run.compared
    low = clip_closed.control(run)
    assert any(v > limits[k] for k, v in low.items()), low
    assert run.attempted >= 1 and run.e2e["clip_fps"] > 0


@pytest.mark.parametrize("extra", [{}, {"image_size": 32, "batch_size_per_card": 1}],
                         ids=["phi", "image"])
def test_training_reference_follows_the_port(extra):
    over = {"params": {**tiny.TRAIN["params"], **extra},
            "config": dict(tiny.TRAIN["config"],
                           feature_dim=2048 if extra else 64)}
    run = tiny.run("train-image-b8t20", over)
    train_steps.run(run)
    assert core.judge(run), run.compared
    assert run.compared["loss_gap"] < 1e-5 and run.compared["grad_gap"] < 1e-4
    assert run.attempted >= 1 and run.e2e["train_fps"] > 0
