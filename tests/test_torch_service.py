"""The port's PredictionService (human_dynamics_tpu_torch.infer.service),
mirroring tests/test_service.py with the port's own small phi-mode
HmmrModel in place of its FakeHmmrModel."""

import sys
import threading

import numpy as np
import pytest
import torch

from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.infer import HmmrPredictor, PredictionService
from human_dynamics_tpu_torch.models import HmmrModel

torch.set_num_threads(1)

RNG = np.random.RandomState(11)
C = 64


@pytest.fixture(scope="module")
def pred():
    model = HmmrModel(feature_dim=C,
                      generator=torch.Generator().manual_seed(0))
    smpl = synthetic_smpl_model(num_verts=48, num_kps=19)
    return HmmrPredictor(model, None, smpl, batch_size=2, seq_length=20,
                         device="cpu")


def clip(n):
    return RNG.randn(n, C).astype(np.float32) * 0.5


def test_service_matches_direct_predict(pred):
    phi = clip(37)
    with PredictionService(pred, as_numpy=True) as service:
        got = service.submit(phi).result(timeout=120)
    want = pred.predict_all_images(phi)
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_service_concurrent_submitters_and_stats(pred):
    """Requests from more threads than cores all resolve with their own
    results, with the interpreter switching threads often; the counters add
    up."""
    clips = {n: clip(n) for n in range(9, 21)}
    results, errors = {}, []

    def worker(n):
        try:
            results[n] = service.submit(clips[n]).result(timeout=300)
        except Exception as e:  # pragma: no cover
            errors.append((n, e))

    threads = [threading.Thread(target=worker, args=(n,)) for n in clips]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with PredictionService(pred, as_numpy=True) as service:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    for n, phi in clips.items():
        assert results[n]["omegas"].shape == (n, 85)
        np.testing.assert_array_equal(
            results[n]["omegas"], pred.predict_all_images(phi)["omegas"],
            err_msg=str(n))
    stats = service.stats()
    assert stats["submitted"] == stats["completed"] == len(clips)
    assert stats["failed"] == 0
    assert stats["frames"] == sum(clips)


def test_service_request_error_isolated(pred):
    """A malformed request fails only its own future."""
    bad = np.zeros((5, 7), np.float32)          # wrong feature dim
    with PredictionService(pred, as_numpy=True) as service:
        fut_bad = service.submit(bad)
        fut_good = service.submit(clip(25))
        with pytest.raises(RuntimeError):
            fut_bad.result(timeout=120)
        out = fut_good.result(timeout=120)
    assert out["omegas"].shape == (25, 85)
    stats = service.stats()
    assert stats["failed"] == 1
    assert stats["completed"] == 1


def test_service_rejects_after_close(pred):
    service = PredictionService(pred)
    service.close()
    service.close()                             # closing twice is harmless
    with pytest.raises(RuntimeError, match="closed"):
        service.submit(np.zeros((4, C), np.float32))


def test_service_close_without_drain_fails_pending(pred):
    service = PredictionService(pred, as_numpy=True)
    # Queue a few; close(drain=False) may fail any still unstarted.
    futs = [service.submit(clip(21)) for _ in range(3)]
    service.close(drain=False)
    for fut in futs:
        try:
            assert fut.result(timeout=120)["omegas"].shape == (21, 85)
        except RuntimeError as e:
            assert "closed" in str(e)
    assert not service._thread.is_alive()


def test_streaming_session_matches_offline(pred):
    """A stream served through the service (open_stream) emits
    offline-identical outputs, interleaved with an offline submit on the
    same dispatcher; after the service closes, feeding raises."""
    phi, other = clip(41), clip(23)
    with PredictionService(pred, as_numpy=True) as service:
        session = service.open_stream()
        assert session.quantum == 16 and session.latency_frames == 22
        futs = [session.feed(chunk) for chunk in np.array_split(phi, 7)]
        offline_fut = service.submit(other)
        futs.append(session.flush())
        emissions = [e for f in futs for e in f.result(timeout=300)]
        offline = offline_fut.result(timeout=300)
        stats = service.stats()

    got = {k: np.concatenate([e[k] for e in emissions])
           for k in emissions[0]}
    want = pred.predict_all_images(phi)
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(offline["omegas"],
                                  pred.predict_all_images(other)["omegas"])
    assert stats["failed"] == 0
    assert stats["frames"] == len(phi) + len(other)
    with pytest.raises(RuntimeError, match="closed"):
        session.feed(phi[:4])


def test_streaming_session_reset_reopens(pred):
    phi = clip(18)
    with PredictionService(pred, as_numpy=True) as service:
        session = service.open_stream()
        session.feed(phi)
        session.flush().result(timeout=300)
        fut = session.feed(phi[:4])   # finished stream -> request fails
        with pytest.raises(RuntimeError, match="reset"):
            fut.result(timeout=300)
        session.reset().result(timeout=300)
        out = [e for f in (session.feed(phi), session.flush())
               for e in f.result(timeout=300)]
        assert sum(len(e["omegas"]) for e in out) == len(phi)
    assert service.stats()["failed"] == 1


def test_service_mesh_not_ported(pred):
    """Multi-GPU serving is ported (tests/test_torch_sharded_inference.py
    drives it over gloo ranks); what stays refused: a service on any rank
    but 0 of its mesh (the others follow), and a bad mesh_mode, rejected
    first, as in the JAX service."""
    class Rank1:
        rank = 1

    with pytest.raises(ValueError, match="follow"):
        PredictionService(pred, mesh=Rank1())
    with pytest.raises(ValueError, match="mesh_mode"):
        PredictionService(pred, mesh=object(), mesh_mode="hallo")


def test_service_results_are_device_tensors_without_grad(pred):
    """Without as_numpy, results are tensors on the predictor's device and
    none records autograd state, offline and streamed."""
    phi = clip(30)
    with PredictionService(pred) as service:
        offline = service.submit(torch.from_numpy(phi)).result(timeout=120)
        session = service.open_stream()
        emissions = session.feed(torch.from_numpy(phi)).result(timeout=120)
        emissions += session.flush().result(timeout=120)
    tensors = list(offline.values()) + [v for e in emissions
                                        for v in e.values()]
    assert tensors and all(isinstance(v, torch.Tensor) for v in tensors)
    assert all(v.device == pred.device for v in tensors)
    assert not any(v.requires_grad for v in tensors)
    streamed = torch.cat([e["omegas"] for e in emissions])
    torch.testing.assert_close(streamed, offline["omegas"], rtol=1e-5,
                               atol=1e-5)
