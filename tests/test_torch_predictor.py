"""The port's windowed predictor (human_dynamics_tpu_torch.infer) against the
JAX HmmrPredictor: the slice as a whole, on the same weights and frames.

Tolerances: omegas, cams, shapes and poses at atol/rtol 1e-4 (narrow
float32 model, sums in another order); joints, kps and verts at the
fused-SMPL tolerance of tests/test_ops_pallas.py, 2e-4. The full ResNet-50
image-mode run holds atol/rtol 1e-4 as well (measured ~1e-6).
"""

import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
from human_dynamics_tpu.infer.predictor import HmmrPredictor as JaxPredictor
from human_dynamics_tpu.infer.window import WindowSchedule as JaxSchedule
from human_dynamics_tpu.models import HmmrModel as JaxModel
from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.infer import HmmrPredictor, WindowSchedule
from human_dynamics_tpu_torch.models import HmmrModel
from human_dynamics_tpu_torch.utils.weights import load_jax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMPL_KEYS = ("joints", "kps", "verts")


def _assert_outputs_close(got, want, atol=1e-4):
    assert set(got) == set(want)
    for k in sorted(want):
        tol = 2e-4 if k.split("_")[0] in SMPL_KEYS else atol
        assert got[k].shape == np.shape(want[k]), k
        np.testing.assert_allclose(
            got[k], np.asarray(want[k]), atol=tol, rtol=1e-4, err_msg=k
        )


def _models(seed=0, example=None, **kw):
    jm = JaxModel(**kw)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), example)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = HmmrModel(device="meta", **kw).to_empty(device="cpu")
    return jm, variables, load_jax_variables(tm, variables)


@pytest.fixture(scope="module")
def phi_models():
    return _models(feature_dim=64, example=jnp.zeros((1, 20, 64)))


@pytest.mark.parametrize("use_fused_smpl", [False, True])
@pytest.mark.parametrize("pred_mode", ["pred", "hal"])
def test_phi_mode_matches_jax(phi_models, use_fused_smpl, pred_mode):
    """N=37 frames: 3 window groups of B=2, the last one ragged; every output
    key, including the *_delta heads in 'pred' mode."""
    jm, variables, tm = phi_models
    phi = np.random.RandomState(1).randn(37, 64).astype(np.float32)
    kw = dict(batch_size=2, seq_length=20, pred_mode=pred_mode,
              use_fused_smpl=use_fused_smpl)
    want = JaxPredictor(
        jm, variables, jax_smpl(num_verts=96, num_kps=25), **kw
    ).predict_all_images(phi)
    got = HmmrPredictor(
        tm, None, synthetic_smpl_model(num_verts=96, num_kps=25),
        groups_per_step=2, device="cpu", **kw,
    ).predict_all_images(phi)
    assert ("verts_delta" in got) == (pred_mode == "pred")
    if pred_mode == "pred":
        assert got["verts_delta"].shape == (37, 2, 96, 3)
        assert got["omegas_delta"].shape == (37, 2, 85)
    _assert_outputs_close(got, want)


def test_image_mode_uint8_full_resnet_matches_jax():
    """The whole slice: raw uint8 frames through ResNet-50 (encode chunks of
    16, a ragged tail), the windows and the fused SMPL decode."""
    jm, variables, tm = _models(
        include_resnet=True, example=jnp.zeros((1, 1, 64, 64, 3))
    )
    raw = np.random.RandomState(2).randint(0, 256, (25, 64, 64, 3))
    raw = raw.astype(np.uint8)
    kw = dict(batch_size=2, seq_length=20, use_fused_smpl=True,
              encode_chunk=16)
    want = JaxPredictor(
        jm, variables, jax_smpl(num_verts=48, num_kps=25), **kw
    ).predict_all_images(raw)
    got = HmmrPredictor(
        tm, None, synthetic_smpl_model(num_verts=48, num_kps=25),
        device="cpu", **kw
    ).predict_all_images(raw)
    assert got["verts"].shape == (25, 48, 3)
    assert got["verts_delta"].shape == (25, 2, 48, 3)
    _assert_outputs_close(got, want)


@pytest.fixture(scope="module")
def image_models():
    return _models(include_resnet=True, example=jnp.zeros((1, 1, 64, 64, 3)))


_RAW = np.random.RandomState(2).randint(0, 256, (25, 64, 64, 3)).astype(
    np.uint8)
_CALIB = np.random.RandomState(4).randint(0, 256, (8, 64, 64, 3)).astype(
    np.uint8)
_INT8 = dict(int8_encoder=True, int8_calibration=_CALIB)
_BENCH = dict(_INT8, bf16_temporal=True, use_fused_smpl=True)

# (options, run on the JAX predictor's own int8 weights and scales, atol on
# every output key or None for the fp32 tolerances). A bf16 or int8 atol is
# 3x the largest max|port - JAX| over the keys, measured on this clip:
# - int8_static, quantised by the port itself: 1.34e-2 (verts_delta;
#   omegas 5.5e-3). The BN fold's rsqrt differs by an ulp between XLA and
#   torch, and XLA rewrites divisions by constants inside jit, so a few
#   int8 roundings flip.
# - the bench config on the JAX int8 weights and scales: 3.9e-3 (cams,
#   omegas): bf16 roundings of the window tail (temporal encoder, IEF
#   heads) in another order.
# - bf16_encoder: 4.3e-3 (verts_delta): bf16 convolutions summed in another
#   order.
# On the JAX int8 weights and scales the int8 encoder agrees to ~1e-6.
_PRECISION_CASES = {
    "int8_static": (_INT8, False, 4e-2),
    "int8_static_jax_params": (_INT8, True, None),
    "int8_dynamic_jax_params": (dict(int8_encoder=True), True, None),
    "bench_config_jax_params": (_BENCH, True, 1.2e-2),
    "bf16_encoder": (dict(bf16_encoder=True), False, 1.3e-2),
}


@pytest.mark.parametrize("case", sorted(_PRECISION_CASES))
def test_precision_options_match_jax(image_models, case):
    """The bf16 and int8 options against the JAX predictor on 25 uint8
    frames of 64x64 (B=2, encode_chunk=16, a ragged tail chunk)."""
    from human_dynamics_tpu_torch.utils.weights import load_jax_int8

    options, jax_params, atol = _PRECISION_CASES[case]
    jm, variables, tm = image_models
    kw = dict(batch_size=2, seq_length=20, encode_chunk=16, **options)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jp = JaxPredictor(jm, variables, jax_smpl(num_verts=48, num_kps=25),
                          **kw)
        tp = HmmrPredictor(tm, None,
                           synthetic_smpl_model(num_verts=48, num_kps=25),
                           device="cpu", **kw)
    if jax_params:
        qp = {k: np.asarray(v) for k, v in jp._int8_qp.items()
              if not k.startswith("calib/")}
        scales = {k[len("calib/"):]: np.asarray(v)
                  for k, v in jp._int8_qp.items() if k.startswith("calib/")}
        tp.set_int8_params(*load_jax_int8(qp, scales or None))
    want = jp.predict_all_images(_RAW)
    got = tp.predict_all_images(_RAW)
    assert got["omegas"].dtype == np.float32
    if atol is None:
        _assert_outputs_close(got, want)
        return
    assert set(got) == set(want)
    for k in sorted(want):
        assert got[k].shape == np.shape(want[k]), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                   rtol=0, err_msg=k)


def test_int8_and_bf16_hold_no_fp32_encoder_copy(image_models):
    """The int8 encoder keeps only its quantised plan (the model's fp32
    ResNet is not moved to the device), and bf16_temporal runs a bf16 copy
    of the window tail without the ResNet, leaving the model fp32."""
    _, _, tm = image_models
    smpl = synthetic_smpl_model(num_verts=48, num_kps=25)
    pred = HmmrPredictor(tm, None, smpl, device="cpu", **_BENCH)
    assert pred._encoder is None and pred._int8_plan is not None
    assert not hasattr(pred._tail, "resnet_v2_50")
    assert pred._tail.single_view_ief.fc1.weight.dtype == torch.bfloat16
    assert tm.single_view_ief.fc1.weight.dtype == torch.float32
    assert hasattr(tm, "resnet_v2_50")


def test_device_defaults_to_cuda_and_never_falls_back(phi_models,
                                                      monkeypatch):
    """device=None means the CUDA device; without one it raises and says
    how to ask for the CPU."""
    _, _, tm = phi_models
    smpl = synthetic_smpl_model(num_verts=32, num_kps=19)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HmmrPredictor(tm, None, smpl)
    assert tm.mean_param.device.type == "cpu"


def test_groups_per_step_state_and_device_outputs(phi_models):
    """Splitting the window groups over several model calls changes
    nothing; as_numpy=False returns tensors on the device; a state_dict
    passed as `state` is loaded."""
    _, _, tm = phi_models
    smpl = synthetic_smpl_model(num_verts=64, num_kps=19)
    phi = np.random.RandomState(3).randn(70, 64).astype(np.float32)
    one = HmmrPredictor(tm, None, smpl, batch_size=2, groups_per_step=8,
                        device="cpu")
    many = HmmrPredictor(tm, None, smpl, batch_size=2, groups_per_step=1,
                         device="cpu")
    a = one.predict_all_images(phi)
    b = many.predict_all_images(torch.from_numpy(phi), as_numpy=False)
    assert all(isinstance(v, torch.Tensor) for v in b.values())
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k], atol=1e-6, err_msg=k)
    # `state` loads a state_dict into the model the predictor is given.
    fresh = HmmrModel(feature_dim=64, device="meta").to_empty(device="cpu")
    c = HmmrPredictor(fresh, tm.state_dict(), smpl, batch_size=2,
                      device="cpu")
    np.testing.assert_array_equal(c.predict_all_images(phi)["omegas"],
                                  a["omegas"])


@pytest.mark.parametrize("options,full_fp32", [
    ({}, (True, True)),
    (dict(bf16_encoder=True), (False, True)),
    (dict(bf16_encoder=True, bf16_temporal=True), (False, False)),
])
def test_fp32_modules_run_without_tf32(image_models, options, full_fp32):
    """The fp32 encoder and the fp32 window tail run with cuDNN's and the
    matmuls' TF32 off, whatever the process's settings, which are restored
    after; bf16 modules are left to them."""
    _, _, tm = image_models
    pred = HmmrPredictor(tm, None, synthetic_smpl_model(num_verts=48,
                                                        num_kps=25),
                         batch_size=2, device="cpu", **options)
    seen = {}

    def record(name):
        def hook(module, args):
            seen[name] = (torch.backends.cudnn.allow_tf32,
                          torch.backends.cuda.matmul.allow_tf32)
        return hook

    handles = [pred._encoder.register_forward_pre_hook(record("encoder")),
               pred._tail.register_forward_pre_hook(record("tail"))]
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pred.predict_all_images(_RAW[:9])
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
        for h in handles:
            h.remove()
    assert after == (True, True)
    for name, full in zip(("encoder", "tail"), full_fp32):
        assert seen[name] == ((False, False) if full else (True, True)), name


def test_predictor_rejects_unported_options(phi_models):
    """unroll_chunks (a TPU compile device) is not ported; the bf16 and
    int8 options are."""
    _, _, tm = phi_models
    smpl = synthetic_smpl_model(num_verts=32, num_kps=19)
    with pytest.raises(TypeError):
        HmmrPredictor(tm, None, smpl, device="cpu", unroll_chunks=True)
    for opt in ("bf16_encoder", "bf16_temporal"):
        HmmrPredictor(tm, None, smpl, device="cpu", **{opt: True})
    with pytest.warns(RuntimeWarning, match="dynamic"):
        HmmrPredictor(tm, None, smpl, device="cpu", int8_encoder=True)
    with pytest.raises(ValueError, match="Pred mode"):
        HmmrPredictor(tm, None, smpl, pred_mode="nope", device="cpu")
    with pytest.raises(ValueError, match="fov"):
        HmmrPredictor(tm, None, smpl, seq_length=12, device="cpu")


@pytest.mark.parametrize("n", [1, 8, 37, 64, 65, 480])
def test_window_schedule_matches_jax(n):
    kw = dict(num_frames=n, batch_size=8, seq_length=20, fov=13)
    got, want = WindowSchedule(**kw), JaxSchedule(**kw)
    for attr in ("margin", "good_frames", "count", "num_windows", "num_fill",
                 "padded_length"):
        assert getattr(got, attr) == getattr(want, attr), attr
    np.testing.assert_array_equal(got.window_starts(), want.window_starts())
    frames = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    np.testing.assert_array_equal(got.pad(frames), want.pad(frames))


def _run(code_or_args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, *code_or_args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor flax nor
    the JAX package, nor cv2 (only JPEG records, the numpy mesh metric,
    skeleton drawing and video writing import it, when they run)."""
    code = (
        "import pkgutil, sys, importlib, human_dynamics_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'human_dynamics_tpu', 'cv2'))\n"
        "print(len(mods)); assert not bad, bad\n"
    )
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr
    # the demo, viz/, datasets/, utils/autorestart and scripts/ included
    assert int(proc.stdout.split()[-1]) >= 76


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device."""
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert not any(json.loads(ln).get("ok") for ln in lines)
