"""The port's viz package (human_dynamics_tpu_torch.viz) against the JAX
package's, on the CPU.

Meshes are small (a UV sphere of 8 x 10, 160 faces local to the surface,
or 40 random faces over 30 vertices), so that the numpy rasterizer stays
quick. Tolerances:
- the rasterizers' masks equal; their RGB within 1e-5 (float32 sums in
  another order in numpy);
- rendered uint8 images within 1 of JAX's (a composite truncates a float
  to uint8, and the original image's resize is torch's in the port and
  cv2's in JAX: float64 values a few ulps apart may fall on either side of
  an integer); masks equal;
- skeletons, text and the camera chain equal (the same numpy and cv2 calls).
"""

import os

import numpy as np
import pytest
import torch

from human_dynamics_tpu.viz import composite as JC
from human_dynamics_tpu.viz import renderer as JR
from human_dynamics_tpu.viz import skeleton as JS
from human_dynamics_tpu_torch.ops._build import BUILD_DIR
from human_dynamics_tpu_torch.viz import composite as PC
from human_dynamics_tpu_torch.viz import renderer as PR
from human_dynamics_tpu_torch.viz import skeleton as PS
from human_dynamics_tpu_torch.viz import video as PV

torch.set_num_threads(1)

RNG = np.random.RandomState(5)
LIGHT = np.asarray([1.0, 0.5, -1.0], np.float32)
CAMS = [np.array([0.9, 0.0, 0.0]), np.array([0.7, 0.15, -0.2]),
        np.array([1.3, -0.3, 0.1])]


def uv_sphere(n_lat=8, n_lon=10, radius=0.6):
    """A UV sphere: 2 + (n_lat - 1) * n_lon vertices, 2 * n_lon * (n_lat -
    1) faces, each spanning a small patch of the surface."""
    lat = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.outer(np.sin(lat), np.cos(lon)),
                     np.repeat(np.cos(lat)[:, None], n_lon, 1),
                     np.outer(np.sin(lat), np.sin(lon))], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]]) * radius

    def idx(i, j):
        return 1 + i * n_lon + j % n_lon

    faces = [(0, idx(0, j + 1), idx(0, j)) for j in range(n_lon)]
    for i in range(n_lat - 2):
        for j in range(n_lon):
            faces += [(idx(i, j), idx(i, j + 1), idx(i + 1, j + 1)),
                      (idx(i, j), idx(i + 1, j + 1), idx(i + 1, j))]
    last = len(verts) - 1
    faces += [(last, idx(n_lat - 2, j), idx(n_lat - 2, j + 1))
              for j in range(n_lon)]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def random_mesh():
    verts = RNG.randn(30, 3).astype(np.float32) * 0.5
    faces = RNG.randint(0, 30, (40, 3)).astype(np.int32)
    return verts, faces


def _within_one(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_rasterizer_builds_into_the_port_build_dir():
    """The C++ rasterizer is the repo's copy, built into ops/_build under a
    hash of its source, never next to the JAX package's source."""
    path = PR.library_path()
    assert os.path.dirname(path) == BUILD_DIR
    assert os.path.isfile(PR.SOURCE)
    assert "human_dynamics_tpu_torch" in PR.SOURCE
    assert PR.load_library() is not None
    assert os.path.exists(path)
    assert not path.startswith(JR._native_dir())


@pytest.mark.parametrize("mesh", ["sphere", "random"])
def test_native_rasterizer_matches_plain_version(mesh):
    """The C++ rasterizer against its numpy plain version: masks equal,
    RGB within 1e-5."""
    verts, faces = uv_sphere() if mesh == "sphere" else random_mesh()
    color = np.asarray(PR.MESH_COLORS["blue"], np.float32)
    for size in (48, 64):
        got = PR.rasterize_native(verts, faces, size, color, LIGHT, 0.3, 0.7)
        want = PR.rasterize_numpy(verts, faces, size, color, LIGHT, 0.3, 0.7)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
        assert got[1].sum() > 0


@pytest.mark.parametrize("backend", PR.BACKENDS)
def test_renderer_matches_jax(backend):
    """VisRenderer (native and numpy) against the JAX package's on the same
    meshes and cameras: the mesh on white, silhouettes, RGBA, a composite
    over an image, a batch, and the rotated view."""
    for verts, faces in (uv_sphere(), random_mesh()):
        got_r = PR.VisRenderer(img_size=56, faces=faces, backend=backend)
        want_r = JR.VisRenderer(img_size=56, faces=faces)
        bg = RNG.randint(0, 256, (56, 56, 3)).astype(np.float64)
        for cam in CAMS:
            for kw in ({}, {"rend_mask": True}, {"alpha": True},
                       {"img": bg}, {"color_name": "pink", "img_size": 40}):
                got, want = got_r(verts, cam=cam, **kw), want_r(
                    verts, cam=cam, **kw)
                _within_one(got, want)
                if kw.get("rend_mask"):
                    np.testing.assert_array_equal(got, want)
            for deg, axis in ((90, "y"), (-35, "x"), (60, "z")):
                _within_one(got_r.rotated(verts, deg, axis=axis, cam=cam),
                            want_r.rotated(verts, deg, axis=axis, cam=cam))
                np.testing.assert_array_equal(
                    got_r.rotated(verts, deg, axis, cam, rend_mask=True),
                    want_r.rotated(verts, deg, axis, cam, rend_mask=True))
        batch = np.stack([verts, verts * 0.5])
        _within_one(got_r(batch, cam=np.stack(CAMS[:2])),
                    want_r(batch, cam=np.stack(CAMS[:2])))


def test_rodrigues_equals_cv2():
    """The rotated view's numpy Rodrigues gives cv2.Rodrigues's matrices
    bit for bit."""
    import cv2

    for vec in ([0, np.pi / 2, 0], [np.deg2rad(-35), 0, 0],
                [0.3, -0.2, 0.9], [0, 0, 1e-20], [0, 0, 0]):
        vec = np.asarray(vec, np.float64)
        np.testing.assert_array_equal(PR.rodrigues(vec), cv2.Rodrigues(vec)[0])


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """A source that does not compile raises from the first render; an
    unknown backend is refused."""
    bad = tmp_path / "rasterizer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(PR, "SOURCE", str(bad))
    monkeypatch.setattr(PR, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(PR, "_LIB", None)
    verts, faces = uv_sphere(4, 5)
    renderer = PR.VisRenderer(img_size=16, faces=faces)
    with pytest.raises(RuntimeError, match="building the rasterizer failed"):
        renderer(verts)
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "build"))
    with pytest.raises(ValueError, match="backend"):
        PR.VisRenderer(img_size=16, faces=faces, backend="cuda")


def test_skeleton_and_text_match_jax():
    img = RNG.randint(0, 256, (96, 96, 3)).astype(np.uint8)
    for k in (14, 19, 25):
        joints = RNG.uniform(5, 90, (k, 2))
        vis = RNG.rand(k) > 0.3
        np.testing.assert_array_equal(PS.draw_skeleton(img, joints),
                                      JS.draw_skeleton(img, joints))
        np.testing.assert_array_equal(
            PS.draw_skeleton(img / 255.0, joints.T, draw_edges=False,
                             vis=vis),
            JS.draw_skeleton(img / 255.0, joints.T, draw_edges=False,
                             vis=vis))
    with pytest.raises(ValueError):
        PS.draw_skeleton(img, RNG.rand(7, 2))
    content = {"err": 1.234, "name": "x"}
    np.testing.assert_array_equal(PS.draw_text(img, content),
                                  JS.draw_text(img, content))
    np.testing.assert_array_equal(
        PS.draw_text(img / 255.0, content),
        JS.draw_text(img / 255.0, content))
    kps = RNG.uniform(-1, 1, (19, 2))
    np.testing.assert_array_equal(PS.normalized_kp_to_image(kps, 224),
                                  JS.normalized_kp_to_image(kps, 224))


def _frame_case(seed):
    """A crop's camera, keypoints and vertices and its crop metadata."""
    rng = np.random.RandomState(seed)
    verts, faces = uv_sphere()
    cam = np.array([0.9, 0.05, -0.1], np.float32)
    kps = rng.uniform(-0.8, 0.8, (19, 2)).astype(np.float32)
    info = {"start_pt": np.array([150, 40]), "scale": 0.8,
            "im_shape": [224, 224]}
    return verts, faces, cam, kps, info


def test_visualize_img_matches_jax():
    """The crop's skeleton, mesh-on-crop (with its text) and rotated
    panels, and a padded square image, against JAX's."""
    verts, faces, cam, kps, _ = _frame_case(1)
    img = RNG.uniform(-1, 1, (64, 64, 3))
    gt = np.concatenate([kps + 0.05, np.ones((19, 1))], 1)
    for kw in (dict(rotated_view=True, no_text=True),
               dict(kp_gt=gt, text={"a": 1})):
        got = PC.visualize_img(img, cam, kps, verts,
                               PR.VisRenderer(64, faces), **kw)
        want = JC.visualize_img(img, cam, kps, verts,
                                JR.VisRenderer(64, faces), **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1 / 255 + 1e-12
    rect = RNG.uniform(-1, 1, (40, 64, 3))
    sq, pads = PC.make_square(rect)
    want_sq, want_pads = JC.make_square(rect)
    np.testing.assert_array_equal(sq, want_sq)
    np.testing.assert_array_equal(pads, want_pads)
    np.testing.assert_array_equal(PC.remove_pads(sq, pads), rect)


@pytest.mark.parametrize("shape", [(200, 260, 3), (360, 480, 3)])
def test_visualize_img_orig_and_camera_chain_match_jax(shape):
    """The mesh and skeleton back in the original frame (resized to at most
    300 px when larger: torch in the port, cv2 in JAX), and the crop ->
    original camera chain, against JAX's; the video-level bbox too."""
    verts, faces, cam, kps, info = _frame_case(2)
    img = RNG.uniform(-1, 1, shape)
    args = (cam, kps, verts)
    kw = dict(start_pt=info["start_pt"], scale=info["scale"],
              proc_img_shape=info["im_shape"], img=img, no_text=True)
    got = PC.visualize_img_orig(*args, PR.VisRenderer(224, faces), **kw)
    want = JC.visualize_img_orig(*args, JR.VisRenderer(224, faces), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1 / 255 + 1e-12
    for undo in (1.25, np.array(1.25) * 0.6):
        np.testing.assert_array_equal(
            PC.crop_to_orig_cam(cam, info["start_pt"], undo, 224, 300),
            JC.crop_to_orig_cam(cam, info["start_pt"], undo, 224, 300))
    cams = np.stack([cam, cam * 1.1])
    kps2 = np.stack([kps, kps * 0.9])
    infos = [info, dict(info, start_pt=np.array([140, 52]), scale=0.75)]
    for g, w in zip(PC.compute_video_bbox(cams, kps2, infos),
                    JC.compute_video_bbox(cams, kps2, infos)):
        np.testing.assert_array_equal(g, w)


def test_make_video_and_dump_frames(tmp_path):
    """In-memory float frames -> an mp4 (ffmpeg, or cv2's writer), then its
    frames dumped back to pngs; a second dump reuses them."""
    frames = [np.full((32, 48, 3), i / 8.0, np.float32) for i in range(8)]
    mp4 = str(tmp_path / "out.mp4")
    PV.make_video(mp4, frames=frames, fps=5)
    assert os.path.getsize(mp4) > 0
    paths = PV.dump_frames(mp4, str(tmp_path / "frames"))
    assert len(paths) == 8 and all(p.endswith(".png") for p in paths)
    assert PV.dump_frames(mp4, str(tmp_path / "frames")) == paths
