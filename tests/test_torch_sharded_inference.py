"""The port's sharded inference (human_dynamics_tpu_torch.parallel.halo, the
predictor's predict_all_images_sharded and the mesh-backed service) against
the JAX package's on the conftest's CPU mesh.

Each port rank group runs as gloo subprocesses on the CPU
(tests/torch_mesh_worker.py), one group per world size, every case of that
size in one run; the JAX functions run jitted on the same weights and
inputs. Tolerances: 1e-5 on omegas and 2e-5 on every other key (the JAX
tests' 2e-5 for their sharded paths); image input (full ResNet-50 at
64x64) at the image-mode bound of tests/test_torch_predictor.py, 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
from human_dynamics_tpu.infer.predictor import HmmrPredictor as JaxPredictor
from human_dynamics_tpu.models import HmmrModel as JaxModel
from human_dynamics_tpu.parallel import make_mesh, make_mesh_2d
from human_dynamics_tpu.parallel.halo import (
    predict_clip_sharded,
    predict_clips_sharded_2d,
)
from human_dynamics_tpu_torch.models import HmmrModel
from human_dynamics_tpu_torch.utils.weights import export_jax_variables
from tests.torch_mesh_worker import run_group

torch.set_num_threads(1)

C = 64
CLIP_NS = (7, 20, 43)
RNG = np.random.RandomState(31)
PHI = {n: RNG.randn(n, C).astype(np.float32) for n in CLIP_NS}
PHI_WIN = RNG.randn(37, C).astype(np.float32) * 0.5
PHI_STREAM = RNG.randn(29, C).astype(np.float32) * 0.5
PHIS_2D = RNG.randn(3, 11, C).astype(np.float32)    # pads 3 -> 4, 11 -> 12
RAW = RNG.randint(0, 256, (25, 64, 64, 3)).astype(np.uint8)
FRAMES_F32 = (RAW.astype(np.float32) * (2.0 / 255.0) - 1.0).astype(np.float32)
WINDOW_KW = dict(batch_size=2, seq_length=20)


def _models(**kw):
    """Both packages' HmmrModel on the same weights: the port's, seeded,
    carried to the JAX layout (cheaper than a JAX init of the ResNet)."""
    tm = HmmrModel(generator=torch.Generator().manual_seed(0), **kw)
    return JaxModel(**kw), export_jax_variables(tm), tm


@pytest.fixture(scope="module")
def phi_models():
    return _models(feature_dim=C)


@pytest.fixture(scope="module")
def image_models():
    return _models(include_resnet=True)


def _inputs():
    out = {f"phi{n}": PHI[n] for n in CLIP_NS}
    out.update(phi_win=PHI_WIN, phi_stream=PHI_STREAM, phis_2d=PHIS_2D,
               raw=RAW, frames_f32=FRAMES_F32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


_PHI = {"model": "phi"}
_CASES = {
    1: [("clip20", "clip", dict(_PHI, phi="phi20")),
        ("clips_2d", "clips_2d", dict(_PHI, phi="phis_2d", shape=(1, 1))),
        ("windowed", "windowed", dict(_PHI, x="phi_win")),
        ("serve", "serve", dict(_PHI, phi="phi43", stream_phi="phi_stream"))],
    2: [(f"clip{n}", "clip", dict(_PHI, phi=f"phi{n}")) for n in CLIP_NS]
    + [("windowed", "windowed", dict(_PHI, x="phi_win")),
       ("clips_2d", "clips_2d", dict(_PHI, phi="phis_2d", shape=(1, 2))),
       ("image_f32", "windowed", dict(model="image", x="frames_f32",
                                      kw=dict(encode_chunk=16))),
       ("image_u8", "windowed", dict(model="image", x="raw",
                                     kw=dict(encode_chunk=16))),
       ("serve", "serve", dict(_PHI, phi="phi43", stream_phi="phi_stream"))],
    4: [("clip43", "clip", dict(_PHI, phi="phi43")),
        ("clips_2d", "clips_2d", dict(_PHI, phi="phis_2d", shape=(2, 2))),
        ("windowed", "windowed", dict(_PHI, x="phi_win"))],
}


@pytest.fixture(scope="module")
def groups(phi_models, image_models, tmp_path_factory):
    """world -> each rank's results of every case of that world size, run
    once per module."""
    models = {"phi": ({"feature_dim": C}, phi_models[2].state_dict())}
    cache = {}

    def get(world):
        if world not in cache:
            m = dict(models)
            if any(kind == "windowed" and a["model"] == "image"
                   for _, kind, a in _CASES[world]):
                m["image"] = ({"include_resnet": True},
                              image_models[2].state_dict())
            cache[world] = run_group(
                tmp_path_factory.mktemp(f"world{world}"), world,
                {"models": m, "inputs": _inputs(), "cases": _CASES[world]})
        return cache[world]

    return get


def _close(got, want, atol=2e-5, omega_atol=1e-5):
    assert set(got) == set(want)
    for k in sorted(want):
        w = np.asarray(want[k])
        g = np.asarray(got[k])
        assert g.shape == w.shape, k
        tol = omega_atol if k.startswith("omegas") else atol
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=k)


# The JAX functions run jitted with the variables as arguments: closed over,
# they would be compiled in as constants (~15 s a program at width 2048).


@pytest.fixture(scope="module")
def jax_clip(phi_models):
    """(devices, n) -> JAX's predict_clip_sharded of PHI[n] on
    make_mesh(devices, "time"), computed once."""
    jm, variables, _ = phi_models
    smpl = jax_smpl(num_verts=48, num_kps=25)
    cache = {}

    def get(n_dev, n):
        if (n_dev, n) not in cache:
            mesh = make_mesh(n_dev, axis_name="time")
            cache[n_dev, n] = jax.jit(lambda v, p: predict_clip_sharded(
                jm, v, smpl, p, mesh))(variables, jnp.asarray(PHI[n]))
        return cache[n_dev, n]

    return get


@pytest.mark.parametrize("world,n", [(1, 20), (2, 7), (2, 20), (2, 43),
                                     (4, 43)])
def test_predict_clip_sharded_matches_jax(jax_clip, groups, world, n):
    """Every rank returns the whole clip, equal to the JAX halo path on a
    mesh of as many devices (padding: 7 -> 8, 43 -> 44 at 2 and 4)."""
    want = jax_clip(world, n)
    ranks = groups(world)
    for res in ranks:
        _close(res[f"clip{n}"], want)
    assert ranks[0][f"clip{n}"]["verts"].shape == (n, 48, 3)


@pytest.mark.parametrize("world,shape", [(1, (1, 1)), (2, (1, 2)),
                                         (4, (2, 2))])
def test_predict_clips_sharded_2d_matches_jax(phi_models, groups, world,
                                              shape):
    """3 clips of 11 frames: clips over data (padded to 4 at 2x2), frames
    over time (padded to 12), against the JAX 2-D function on the same
    mesh shape."""
    jm, variables, _ = phi_models
    mesh = make_mesh_2d(*shape)
    smpl = jax_smpl(num_verts=48, num_kps=25)
    want = jax.jit(lambda v, p: predict_clips_sharded_2d(
        jm, v, smpl, p, mesh))(variables, jnp.asarray(PHIS_2D))
    for res in groups(world):
        _close(res["clips_2d"], want)
        assert res["clips_2d"]["omegas"].shape == (3, 11, 85)


def _jax_windowed(models, n_dev, x, **kw):
    """The JAX predictor's predict_all_images_sharded on make_mesh(n_dev)."""
    jm, variables, _ = models
    mesh = make_mesh(n_dev)
    smpl = jax_smpl(num_verts=48, num_kps=25)

    def run(v, x):
        jp = JaxPredictor(jm, v, smpl, **WINDOW_KW, **kw)
        return jp.predict_all_images_sharded(x, mesh, as_numpy=False)

    return jax.jit(run)(variables, jnp.asarray(x))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_predict_all_images_sharded_matches_jax(phi_models, groups, world):
    """37 frames, B=2: 3 window groups rounded up to the world size (4 at 2
    and 4 ranks: padding groups), on every rank."""
    want = _jax_windowed(phi_models, world, PHI_WIN)
    for res in groups(world):
        _close(res["windowed"], want)
        assert res["windowed"]["verts_delta"].shape == (37, 2, 48, 3)


def test_sharded_image_input_and_encode_frames(image_models, groups):
    """ROADMAP Queue 3's encode_frames item, pinned at 2 ranks (full
    ResNet-50, 25 frames of 64x64).

    - [-1, 1] f32 frames under the fp32 encoder: the port's sharded path
      equals JAX's sharded path (both encode the frames as they are).
    - uint8 frames: JAX's encode_frames skips the uint8 normalisation (and
      any configured bf16 or int8 encoder) and feeds the raw 0..255 values
      to the fp32 ResNet, so its sharded path is not its
      predict_all_images. The port encodes with its own encode_frames
      (normalised, the configured encoder) and equals JAX's
      predict_all_images; JAX's sharded path is far from both (stated
      below, not a port fault).
    """
    jm, variables, _ = image_models
    jp = JaxPredictor(jm, variables, jax_smpl(num_verts=48, num_kps=25),
                      encode_chunk=16, **WINDOW_KW)
    ranks = groups(2)
    sharded_f32 = _jax_windowed(image_models, 2, FRAMES_F32,
                                encode_chunk=16)
    for res in ranks:
        _close(res["image_f32"], sharded_f32, atol=1e-4, omega_atol=1e-4)

    offline_u8 = jp.predict_all_images(RAW)
    for res in ranks:
        _close(res["image_u8"], offline_u8, atol=1e-4, omega_atol=1e-4)
    # JAX's sharded path on uint8 frames: its encode_frames casts them to
    # f32 as they are, the same program on the raw values.
    jax_sharded_u8 = _jax_windowed(image_models, 2, RAW.astype(np.float32),
                                   encode_chunk=16)
    gap = float(np.abs(np.asarray(jax_sharded_u8["omegas"])
                       - offline_u8["omegas"]).max())
    assert gap > 1e-2, gap


def test_service_mesh_modes_match_jax(phi_models, jax_clip, groups):
    """A mesh-backed service on rank 0 with a follower on rank 1 (and alone
    at world 1): windowed clips equal JAX's predict_all_images, halo clips
    JAX's predict_clip_sharded (keys included); a live stream on the same
    service stays on rank 0 and matches offline; a request of the wrong
    width fails only its own future, before any collective; each close()
    stops the follower."""
    jm, variables, _ = phi_models
    jp = JaxPredictor(jm, variables, jax_smpl(num_verts=48, num_kps=25),
                      **WINDOW_KW)
    windowed_want = jp.predict_all_images(PHI[43])
    stream_want = jp.predict_all_images(PHI_STREAM)["omegas"]
    for world in (1, 2):
        ranks = groups(world)
        serve = ranks[0]["serve"]
        halo_want = jax_clip(world, 43)
        _close(serve["windowed"]["result"], windowed_want)
        _close(serve["halo"]["result"], halo_want)
        np.testing.assert_allclose(serve["windowed"]["stream_omegas"],
                                   stream_want, atol=1e-5, rtol=0)
        for mode in ("windowed", "halo"):
            assert "features of shape (5, 7)" in serve[mode]["bad_error"]
            stats = serve[mode]["stats"]
            assert stats["failed"] == 1
            assert stats["completed"] == stats["submitted"] - 1
            for follower in ranks[1:]:
                assert follower["serve"][mode] == {"served": 1, "failed": 0}
