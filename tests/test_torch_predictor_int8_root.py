"""The port's predictor and streaming predictor with the int8 root stems
and the int8 residual stream (``HmmrPredictor(int8_root=, int8_stream=)``)
against the JAX HmmrPredictor with the same options, on the JAX
predictor's own int8 weights and scales, 25 uint8 frames of 64x64 (B=2,
encode_chunk=16, a ragged tail chunk).

Tolerances: the fp32 ones of tests/test_torch_predictor.py (atol/rtol 1e-4;
joints, kps and verts 2e-4): the int8 encoder gives JAX's phi bit for bit
(tests/test_torch_resnet_int8_root.py), the fp32 window tail sums in
another order. The "u8" stem on uint8 frames against the same frames as
floats: atol 1e-4, as the JAX test (tests/test_resnet_int8.py:208-211).
Calibration scales: rtol 1e-5, as tests/test_torch_resnet_int8.py's.

JAX is imported inside fixtures.
"""

import warnings

import numpy as np
import pytest
import torch

from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.infer import HmmrPredictor, StreamingPredictor
from human_dynamics_tpu_torch.utils.weights import load_jax_int8

torch.set_num_threads(1)

_RAW = np.random.RandomState(2).randint(0, 256, (25, 64, 64, 3)).astype(
    np.uint8)
_CALIB = np.random.RandomState(4).randint(0, 256, (8, 64, 64, 3)).astype(
    np.uint8)
_KW = dict(batch_size=2, seq_length=20, encode_chunk=16, int8_encoder=True,
           int8_calibration=_CALIB)
# Every int8_root stem and both int8_stream forms, three JAX programs (a
# full-ResNet predictor compiles in ~10 s).
CASES = {
    "s2d_stream_all": dict(int8_root=True, int8_stream=True),
    "wfold_stream_1": dict(int8_root="wfold", int8_stream=(1,)),
    "u8": dict(int8_root="u8"),
}
_JAX = {}
SMPL_KEYS = ("joints", "kps", "verts")


def _smpl():
    return synthetic_smpl_model(num_verts=48, num_kps=25)


def _assert_outputs_close(got, want, atol=1e-4):
    assert set(got) == set(want)
    for k in sorted(want):
        tol = 2e-4 if k.split("_")[0] in SMPL_KEYS else atol
        assert np.shape(got[k]) == np.shape(want[k]), k
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=tol, rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def image_models():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from tests.test_torch_predictor import _models

    return _models(include_resnet=True, example=jnp.zeros((1, 1, 64, 64, 3)))


def _jax_predictor(image_models, case):
    """The JAX predictor of a case, made once."""
    from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
    from human_dynamics_tpu.infer.predictor import (
        HmmrPredictor as JaxPredictor,
    )

    if case not in _JAX:
        jm, variables, _ = image_models
        _JAX[case] = JaxPredictor(
            jm, variables, jax_smpl(num_verts=48, num_kps=25),
            **dict(_KW, **CASES[case]))
    return _JAX[case]


def _jax_int8(jp):
    """The JAX predictor's int8 weights and calibrated scales."""
    qp = {k: np.asarray(v) for k, v in jp._int8_qp.items()
          if not k.startswith("calib/")}
    scales = {k[len("calib/"):]: np.asarray(v)
              for k, v in jp._int8_qp.items() if k.startswith("calib/")}
    return qp, scales


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_root_and_stream_predictor_matches_jax(image_models, case):
    _, _, tm = image_models
    jp = _jax_predictor(image_models, case)
    tp = HmmrPredictor(tm, None, _smpl(), device="cpu",
                       **dict(_KW, **CASES[case]))
    tp.set_int8_params(*load_jax_int8(*_jax_int8(jp)))
    want = jp.predict_all_images(_RAW)
    got = tp.predict_all_images(_RAW)
    assert got["omegas"].dtype == np.float32
    _assert_outputs_close(got, want)


def test_u8_bytes_match_floats_and_calibration_matches_jax(image_models):
    """The byte-direct stem gives the same outputs on uint8 frames as on
    the frames normalised to floats, and the predictor calibrates under it
    as the JAX predictor does (on the bf16-root dynamic trunk, from the
    uint8 calibration frames normalised by a separate multiply and add)."""
    _, _, tm = image_models
    tp = HmmrPredictor(tm, None, _smpl(), device="cpu", int8_root="u8",
                       **_KW)
    floats = _RAW.astype(np.float32) * np.float32(2.0 / 255.0) - 1.0
    _assert_outputs_close(tp.predict_all_images(floats),
                          tp.predict_all_images(_RAW))
    _, want = _jax_int8(_jax_predictor(image_models, "u8"))
    assert set(tp.int8_scales) == set(want)
    for k, v in tp.int8_scales.items():
        np.testing.assert_allclose(float(v), want[k], rtol=1e-5, err_msg=k)


def test_int8_root_and_stream_need_calibration(image_models):
    _, _, tm = image_models
    kw = {k: v for k, v in _KW.items() if k != "int8_calibration"}
    for opt in (dict(int8_root="u8"), dict(int8_stream=(1,))):
        with pytest.raises(ValueError, match="int8_calibration"):
            HmmrPredictor(tm, None, _smpl(), device="cpu", **kw, **opt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tp = HmmrPredictor(tm, None, _smpl(), device="cpu", **kw)
    tp.int8_root = "u8"
    with pytest.raises(ValueError, match="static scales"):
        tp.set_int8_params(tp._int8_qp)


def test_u8_stream_matches_offline(image_models):
    """A uint8 stream through the byte-direct stem, fed in pieces of 1, 7,
    3 and 11 frames and flushed (3 frames left for the flush), against
    predict_all_images on the same frames; every step's frames reach the
    stem as bytes."""
    _, _, tm = image_models
    tp = HmmrPredictor(tm, None, _smpl(), device="cpu", int8_root="u8",
                       int8_stream=(1,), **_KW)
    seen = []
    real = tp._int8_plan
    import human_dynamics_tpu_torch.infer.predictor as P

    run = P.run_int8_static

    def spy(plan, chunk):
        assert plan is real
        seen.append(chunk.dtype)
        return run(plan, chunk)

    P.run_int8_static = spy
    try:
        sp = StreamingPredictor(tp)
        emissions, i, j = [], 0, 0
        while i < len(_RAW):
            n = (1, 7, 3, 11)[j % 4]
            emissions += sp.feed(_RAW[i:i + n])
            i, j = i + n, j + 1
        emissions += sp.flush()
    finally:
        P.run_int8_static = run
    assert seen and set(seen) == {torch.uint8}
    got = {k: torch.cat([e[k] for e in emissions]).numpy()
           for k in emissions[0]}
    _assert_outputs_close(got, tp.predict_all_images(_RAW))
