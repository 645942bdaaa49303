"""The port's StreamingPredictor (human_dynamics_tpu_torch.infer.streaming)
against the JAX StreamingPredictor and against the port's own offline
predict_all_images, on the same weights and frames.

Tolerances: phi mode rtol = atol = 1e-5 on every key (the JAX streaming
test's bound); image mode fp32 1e-4 on omegas; the int8 encoders 1e-3 on
omegas (tests/test_streaming.py's bound), on the JAX predictor's own int8
weights and scales.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
from human_dynamics_tpu.infer import StreamingPredictor as JaxStreaming
from human_dynamics_tpu.infer.predictor import HmmrPredictor as JaxPredictor
from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.infer import HmmrPredictor, StreamingPredictor
from human_dynamics_tpu_torch.infer.streaming import _bucket
from human_dynamics_tpu_torch.utils.weights import load_jax_int8
from tests.test_torch_predictor import _models

torch.set_num_threads(1)

SIZES = (1, 3, 7, 11)


def collect(emissions):
    outs = {}
    for e in emissions:
        for k, v in e.items():
            outs.setdefault(k, []).append(np.asarray(v))
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}


def feed_in_pieces(sp, frames, sizes):
    """Feed `frames` in pieces cycling through `sizes`, then flush."""
    emissions, i, j = [], 0, 0
    while i < len(frames):
        n = sizes[j % len(sizes)]
        emissions += sp.feed(frames[i:i + n])
        i, j = i + n, j + 1
    return emissions + sp.flush()


def assert_close(got, want, keys=None, tol=1e-5):
    assert set(got) == set(want)
    for k in sorted(want):
        assert got[k].shape == np.shape(want[k]), k
    for k in keys or sorted(want):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=tol,
                                   atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def phi_pair():
    jm, variables, tm = _models(feature_dim=64, example=jnp.zeros((1, 20, 64)))
    kw = dict(batch_size=2, seq_length=20)
    jp = JaxPredictor(jm, variables, jax_smpl(num_verts=48, num_kps=25), **kw)
    tp = HmmrPredictor(tm, None, synthetic_smpl_model(num_verts=48,
                                                      num_kps=25),
                       device="cpu", **kw)
    return jp, tp


@pytest.mark.parametrize("n_frames", [5, 8, 23, 40])
def test_streaming_phi_mode_matches_jax_and_offline(phi_pair, n_frames):
    """Uneven pieces: the port's emissions equal the JAX streaming
    emissions and the port's offline stitch, frame for frame."""
    jp, tp = phi_pair
    phi = np.random.RandomState(n_frames).randn(n_frames, 64).astype(
        np.float32)
    got = collect(feed_in_pieces(StreamingPredictor(tp, as_numpy=True), phi,
                                 SIZES))
    want_jax = collect(feed_in_pieces(JaxStreaming(jp, as_numpy=True), phi,
                                      SIZES))
    assert_close(got, want_jax)
    assert_close(got, tp.predict_all_images(phi))


def test_streaming_quantum_and_latency(phi_pair):
    """Emissions arrive exactly when quantum+margin frames exist; a finished
    stream refuses frames until reset."""
    _, tp = phi_pair
    one = HmmrPredictor(tp.model, None, tp.smpl, batch_size=1, seq_length=20,
                        device="cpu")
    sp = StreamingPredictor(one)
    assert sp.quantum == 8 and sp.margin == 6
    assert sp.latency_frames == 14
    phi = np.random.RandomState(5).randn(30, 64).astype(np.float32)
    # 13 frames: not enough for the first step (needs 8+6).
    assert sp.feed(phi[:13]) == []
    out = sp.feed(phi[13:14])
    assert len(out) == 1 and out[0]["omegas"].shape[0] == 8
    assert isinstance(out[0]["omegas"], torch.Tensor)
    # 16 more frames -> two more steps.
    assert len(sp.feed(torch.from_numpy(phi[14:30]))) == 2
    # flush covers the remaining 30 - 24 = 6 frames.
    assert sum(o["omegas"].shape[0] for o in sp.flush()) == 6
    with pytest.raises(RuntimeError, match="reset"):
        sp.feed(phi[:1])
    with pytest.raises(RuntimeError, match="reset"):
        sp.flush()
    sp.reset()
    assert sp.feed(phi[:5]) == []


def test_streaming_empty_and_flush_only(phi_pair):
    """An empty stream emits nothing; a stream shorter than one quantum
    emits everything on flush, as offline."""
    _, tp = phi_pair
    sp = StreamingPredictor(tp)
    assert sp.feed(np.zeros((0, 64), np.float32)) == []
    assert sp.flush() == []
    phi = np.random.RandomState(6).randn(4, 64).astype(np.float32)
    sp = StreamingPredictor(tp, as_numpy=True)
    assert sp.feed(phi) == []
    assert_close(collect(sp.flush()), tp.predict_all_images(phi))


@pytest.fixture(scope="module")
def image_models():
    return _models(include_resnet=True, example=jnp.zeros((1, 1, 64, 64, 3)))


def _image_pair(image_models, jax_int8=False, **kw):
    """The JAX and the port predictor on the same weights; with jax_int8,
    the port's int8 encoder runs the JAX predictor's quantised weights and
    scales."""
    jm, variables, tm = image_models
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jp = JaxPredictor(jm, variables, jax_smpl(num_verts=48, num_kps=25),
                          seq_length=20, **kw)
        tp = HmmrPredictor(tm, None,
                           synthetic_smpl_model(num_verts=48, num_kps=25),
                           seq_length=20, device="cpu", **kw)
    if jax_int8:
        qp = {k: np.asarray(v) for k, v in jp._int8_qp.items()
              if not k.startswith("calib/")}
        scales = {k[len("calib/"):]: np.asarray(v)
                  for k, v in jp._int8_qp.items() if k.startswith("calib/")}
        tp.set_int8_params(*load_jax_int8(qp, scales or None))
    return jp, tp


def test_streaming_image_mode_fp32_matches_jax(image_models):
    """fp32 image mode, float frames in [-1, 1]: emissions against the JAX
    streaming emissions."""
    jp, tp = _image_pair(image_models, batch_size=2, encode_chunk=8)
    frames = np.random.RandomState(8).rand(17, 64, 64, 3).astype(
        np.float32) * 2 - 1
    got = collect(feed_in_pieces(StreamingPredictor(tp, as_numpy=True),
                                 frames, (6,)))
    want = collect(feed_in_pieces(JaxStreaming(jp, as_numpy=True), frames,
                                  (6,)))
    assert_close(got, want, keys=["omegas"], tol=1e-4)


def test_streaming_image_mode_static_int8_uint8_matches_jax(image_models):
    """uint8 frames of 32x32, the static int8 encoder without int8_root:
    emissions against the JAX streaming emissions; then the mixed-dtype
    error."""
    calib = np.random.RandomState(9).randint(0, 256, (8, 32, 32, 3)).astype(
        np.uint8)
    jp, tp = _image_pair(image_models, jax_int8=True, batch_size=1,
                         encode_chunk=8, int8_encoder=True,
                         int8_calibration=calib)
    frames = np.random.RandomState(10).randint(
        0, 256, (21, 32, 32, 3)).astype(np.uint8)
    got = collect(feed_in_pieces(StreamingPredictor(tp, as_numpy=True),
                                 frames, (2, 5, 9)))
    want = collect(feed_in_pieces(JaxStreaming(jp, as_numpy=True), frames,
                                  (2, 5, 9)))
    assert_close(got, want, keys=["omegas"], tol=1e-3)

    sp = StreamingPredictor(tp)
    sp.feed(frames[:2])
    with pytest.raises(ValueError, match="mixed"):
        sp.feed(frames[:2].astype(np.float32))


def test_streaming_dynamic_int8_long_take_and_flush_padding(image_models,
                                                            monkeypatch):
    """Dynamic int8 scales are per encoder call. With batch_size=16 the
    first step encodes 16*8+6 = 134 frames, more than encode_chunk (120):
    they are encoded in one call, not cropped to the chunk. The flush
    encodes its 5 frames zero-padded to _bucket(5) = 6 frames, as the JAX
    streaming flush does. 32x32 frames keep the 139-frame clip cheap."""
    jp, tp = _image_pair(image_models, jax_int8=True, batch_size=16,
                         encode_chunk=120, int8_encoder=True)
    assert tp._int8_qp is not None
    calls = []
    encode = tp._encode_chunk

    def recording(chunk, pad_to=None):
        calls.append((len(chunk), pad_to))
        return encode(chunk, pad_to=pad_to)

    monkeypatch.setattr(tp, "_encode_chunk", recording)
    frames = np.random.RandomState(11).randint(
        0, 256, (139, 32, 32, 3)).astype(np.uint8)
    sizes = (64, 37, 38)
    got = feed_in_pieces(StreamingPredictor(tp, as_numpy=True), frames, sizes)
    want = feed_in_pieces(JaxStreaming(jp, as_numpy=True), frames, sizes)
    assert calls == [(134, None), (5, _bucket(5))] and _bucket(5) == 6
    assert [len(e["omegas"]) for e in got] == [128, 11]
    assert_close(collect(got), collect(want), keys=["omegas"], tol=1e-3)
    with pytest.raises(ValueError, match="pad"):
        encode(torch.from_numpy(frames[:5]), pad_to=4)
