"""The port's dataset converters and tools (human_dynamics_tpu_torch.datasets,
utils.autorestart) against the JAX package's, on the same synthetic inputs,
on the CPU. The device parts (phis, the augmented tube writer, the
neutral-shape fit) are held in tests/test_torch_datasets_phi.py.

Both packages use the same cv2, record schema and record writer, so their
records and files are compared byte for byte: the JPEG coder, crop_person
(cv2's uint8 resize), the test records, every converter's records (train
tubes without an extractor: no device work), reencode_records and the mocap
records. Mappings and tube segments are compared equal, rectify_joints
within 1e-12 (float64; the same operations), and the H3.6M raw readers'
arrays equal (np.savez stamps its zip entries with the time, so its files
are compared by content).
"""

import os
import pickle
import sys
import types
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from human_dynamics_tpu.datasets import common as JC
from human_dynamics_tpu.datasets import h36m as JH
from human_dynamics_tpu.datasets import h36m_raw as JR
from human_dynamics_tpu.datasets import insta_download as JD
from human_dynamics_tpu.datasets import insta_variety as JI
from human_dynamics_tpu.datasets import mocap as JM
from human_dynamics_tpu.datasets import penn_action as JP
from human_dynamics_tpu.datasets import reencode_records as JRe
from human_dynamics_tpu.datasets import tdpw as JT
from human_dynamics_tpu.datasets import test_records as JTR
from human_dynamics_tpu.datasets import visualize_records as JV
from human_dynamics_tpu.utils import autorestart as JA
from human_dynamics_tpu_torch.data.loader import MocapStream
from human_dynamics_tpu_torch.data.tfrecord import read_tfrecord
from human_dynamics_tpu_torch.datasets import common as PC
from human_dynamics_tpu_torch.datasets import h36m as PH
from human_dynamics_tpu_torch.datasets import h36m_raw as PR
from human_dynamics_tpu_torch.datasets import insta_download as PD
from human_dynamics_tpu_torch.datasets import insta_variety as PI
from human_dynamics_tpu_torch.datasets import mocap as PM
from human_dynamics_tpu_torch.datasets import penn_action as PP
from human_dynamics_tpu_torch.datasets import reencode_records as PRe
from human_dynamics_tpu_torch.datasets import tdpw as PT
from human_dynamics_tpu_torch.datasets import test_records as PTR
from human_dynamics_tpu_torch.datasets import visualize_records as PV
from human_dynamics_tpu_torch.utils import autorestart as PA

torch.set_num_threads(1)

N = 45            # frames of a sequence: above clean_tube's 40
HW = (240, 320)


def _tree_bytes(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _walk_kps(n, k=25, seed=0):
    """A person walking right, ~120 px tall, a few joints invisible."""
    rng = np.random.RandomState(seed)
    kps = np.zeros((n, k, 3))
    kps[:, :, 0] = 140 + 1.5 * np.arange(n)[:, None] + np.linspace(-25, 25, k)
    kps[:, :, 1] = 120 + np.linspace(-60, 60, k) + rng.randn(n, k)
    kps[:, :, 2] = rng.rand(n, k) > 0.1
    return kps


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """N noise frames, in memory and as image_%05d.jpg files."""
    import cv2

    d = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(7)
    images, paths = [], []
    for i in range(N):
        img = rng.randint(0, 256, HW + (3,), dtype=np.uint8)
        p = str(d / f"image_{i:05d}.jpg")
        cv2.imwrite(p, img)
        images.append(img)
        paths.append(p)
    return str(d), paths, images


def test_jpeg_coder_byte_equal(frames):
    """encode_jpeg (uint8, float, another quality), decode_jpeg and
    load_image give the JAX package's bytes and pixels."""
    _, paths, images = frames
    y, x = np.mgrid[0:64, 0:64]
    smooth = np.stack([x * 4, y * 4, (x + y) * 2], axis=2).astype(np.uint8)
    for img, kw in ((smooth, {}), (images[0], {}),
                    (images[1].astype(np.float64) * 1.1 - 7, {}),
                    (smooth, {"quality": 60})):
        data = PC.encode_jpeg(img, **kw)
        assert data == JC.encode_jpeg(img, **kw)
        np.testing.assert_array_equal(PC.decode_jpeg(data),
                                      JC.decode_jpeg(data))
    np.testing.assert_array_equal(PC.load_image(paths[2]),
                                  JC.load_image(paths[2]))
    with pytest.raises(FileNotFoundError):
        PC.load_image(paths[0] + ".missing")


@pytest.mark.parametrize("crop_size,cx", [(300, 160.0), (224, 160.0),
                                          (300, 500.0), (224, -300.0)],
                         ids=["train300", "test224", "ragged300",
                              "off_frame224"])
def test_crop_person_byte_equal(frames, crop_size, cx):
    """Every field of crop_person equal to the JAX package's, the crop and
    its JPEG bytes included (cv2's uint8 resize); a centre far right of the
    frame gives a ragged crop in both, one far left a crop whose slice
    starts below 0 (numpy's negative-index slicing)."""
    _, _, images = frames
    kps = _walk_kps(1)[0]
    bbox = np.array([cx, 120.0, 1.37])
    got = PC.crop_person(images[3], kps, bbox, crop_size, vis_thresh=0.1)
    want = JC.crop_person(images[3], kps, bbox, crop_size, vis_thresh=0.1)
    assert set(got) == set(want)
    assert got["image_data"] == want["image_data"]
    for k in ("image", "label", "center", "start_pt", "scale_factors"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    assert got["image_shape"] == want["image_shape"]
    assert got["scale"] == want["scale"]
    assert ((crop_size, crop_size) != tuple(got["image_shape"])) == (
        cx == 500.0)
    assert PC.crop_person(images[3], kps, bbox, crop_size,
                          encode=False)["image_data"] is None


def test_clean_tube_matches_jax():
    """Random tracks with missing, sparse, face-only and long runs."""
    rng = np.random.RandomState(8)
    face_only = np.zeros((25, 3))
    face_only[14:19, 2] = 1.0
    for trial in range(20):
        kps = []
        for _ in range(rng.randint(50, 1200)):
            r = rng.rand()
            kps.append(None if r < 0.01 else face_only if r < 0.02
                       else np.c_[rng.rand(25, 2),
                                  rng.rand(25) > (0.9 if r < 0.03 else 0.2)])
        kw = dict(min_length=rng.randint(5, 60), max_length=500)
        assert PC.clean_tube(kps, **kw) == JC.clean_tube(kps, **kw)


def test_save_seq_to_test_tfrecord_byte_equal(frames, tmp_path):
    """Two people with 3-D joints, poses and shapes, from files and from
    in-memory frames; one person through separate tube paths."""
    _, paths, images = frames
    rng = np.random.RandomState(9)
    people = [_walk_kps(N, seed=s) for s in (1, 2)]
    gt3ds = [rng.randn(N, 14, 3) for _ in people]
    poses = [rng.randn(N, 72) * 0.2 for _ in people]
    shapes = [rng.randn(10) * 0.3 for _ in people]
    cases = [
        dict(im_paths=paths, all_gt2ds=people, all_gt3ds=gt3ds,
             all_poses=poses, all_shapes=shapes),
        dict(im_paths=paths, all_gt2ds=people[:1], all_images=images,
             sigma=8),
        dict(im_paths=[paths], all_gt2ds=people[1:], separate_tubes=True,
             vis_thresh=0.0, img_size=300),
    ]
    for i, kw in enumerate(cases):
        want, got = str(tmp_path / f"j{i}.tfrecord"), str(tmp_path /
                                                         f"p{i}.tfrecord")
        JTR.save_seq_to_test_tfrecord(want, **kw)
        PTR.save_seq_to_test_tfrecord(got, **kw)
        with open(got, "rb") as g, open(want, "rb") as w:
            assert g.read() == w.read(), i


def _penn(root, frames_dir):
    from scipy.io import savemat

    os.makedirs(os.path.join(root, "labels"))
    os.makedirs(os.path.join(root, "frames"))
    for i, train in enumerate((1, 0, 1)):
        kps = _walk_kps(N, k=13, seed=10 + i)
        savemat(os.path.join(root, "labels", f"{i:04d}.mat"), {
            "x": kps[..., 0], "y": kps[..., 1], "visibility": kps[..., 2],
            "train": np.array([[train]])})
        os.symlink(frames_dir, os.path.join(root, "frames", f"{i:04d}"))


def _h36m(root, frames_dir):
    rng = np.random.RandomState(11)
    for seq in ("S1_Walking_0_cam00", "S9_Walking_0_cam03", "S5_Eating_1"):
        d = os.path.join(root, seq)
        os.makedirs(d)
        os.symlink(frames_dir, os.path.join(d, "frames"))
        np.save(os.path.join(d, "gt2d.npy"), _walk_kps(N, k=14, seed=12))
        np.save(os.path.join(d, "gt3d.npy"), rng.randn(N, 14, 3))
        if seq.startswith("S1"):
            np.save(os.path.join(d, "pose.npy"), rng.randn(N, 72))
            np.save(os.path.join(d, "shape.npy"), rng.randn(10))


def _tdpw(root, frames_dir):
    rng = np.random.RandomState(13)
    os.makedirs(os.path.join(root, "sequenceFiles", "test"))
    os.makedirs(os.path.join(root, "imageFiles"))
    kps18 = [np.transpose(_walk_kps(N, k=18, seed=14 + p), (0, 2, 1))
             for p in range(2)]
    cam = np.tile(np.eye(4), (N, 1, 1))
    cam[:, :3, :3] = [JR.euler_xyz_to_rotation(a)
                      for a in rng.randn(N, 3) * 0.1]
    data = dict(poses=[rng.randn(N, 72) * 0.2 for _ in kps18],
                poses2d=kps18, img_frame_ids=np.arange(N),
                betas=[rng.randn(16) for _ in kps18],
                jointPositions=[rng.randn(N, 72) for _ in kps18],
                cam_poses=cam)
    with open(os.path.join(root, "sequenceFiles", "test", "walk_00.pkl"),
              "wb") as f:
        pickle.dump(data, f)
    os.symlink(frames_dir, os.path.join(root, "imageFiles", "walk_00"))


def _insta(root, frames_dir):
    import json

    os.makedirs(os.path.join(root, "tracks"))
    os.makedirs(os.path.join(root, "frames"))
    kps = _walk_kps(N, seed=15)
    track = [{"people": [] if i == 20 else
              [{"pose_keypoints_2d": kps[i].ravel().tolist()}]}
             for i in range(N)]
    with open(os.path.join(root, "tracks", "vid0.json"), "w") as f:
        json.dump(track[:20] + track[21:] + track[:22], f)
    os.symlink(frames_dir, os.path.join(root, "frames", "vid0"))


CONVERTERS = {
    "penn_test": (_penn, lambda m, r, o: m.convert(r, o, "test")),
    "penn_train": (_penn, lambda m, r, o: m.convert(r, o, "train",
                                                    tubes_per_shard=1)),
    "h36m_test": (_h36m, lambda m, r, o: m.convert(r, o, "test")),
    "h36m_train": (_h36m, lambda m, r, o: m.convert(r, o, "train")),
    "h36m_val_mosh_ignore": (_h36m, lambda m, r, o: m.convert(
        r, o, "val", mosh_ignore=True)),
    "tdpw": (_tdpw, lambda m, r, o: m.process_3dpw(r, o)),
    "insta_openpose": (_insta, lambda m, r, o: m.convert(
        os.path.join(r, "tracks"), os.path.join(r, "frames"), o,
        num_copies=2)),
}
PACKAGES = {"penn": (JP, PP), "h36m": (JH, PH), "tdpw": (JT, PT),
            "insta": (JI, PI)}


@pytest.mark.parametrize("case", list(CONVERTERS))
def test_converter_records_byte_equal(frames, tmp_path, case):
    """Each converter on a synthetic copy of its dataset's layout: every
    record file byte-equal to the JAX package's (train tubes without an
    extractor keep no frames and need no device); a rerun writes
    nothing new."""
    frames_dir = frames[0]
    make, run = CONVERTERS[case]
    jax_mod, port_mod = PACKAGES[case.split("_")[0]]
    make(str(tmp_path / "raw"), frames_dir)
    run(jax_mod, str(tmp_path / "raw"), str(tmp_path / "jax"))
    run(port_mod, str(tmp_path / "raw"), str(tmp_path / "port"))
    want = _tree_bytes(str(tmp_path / "jax"))
    got = _tree_bytes(str(tmp_path / "port"))
    assert any(k.endswith(".tfrecord") for k in want), sorted(want)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    run(port_mod, str(tmp_path / "raw"), str(tmp_path / "port"))
    assert _tree_bytes(str(tmp_path / "port")) == got


class _StubExtractor:
    """Stands in for the phi extractor a CLI builds from --resnet_ckpt and
    --device: each crop's channel means as its phi."""

    made = []

    def __init__(self, resnet, device=None):
        self.made.append((resnet, device))
        self.device = torch.device(device)

    def compute_all_phis(self, images):
        return images.mean(dim=(1, 2)).cpu().numpy()


@pytest.mark.parametrize("case", ["penn_action", "h36m", "insta_variety"])
def test_train_cli_takes_resnet_ckpt_and_device(frames, tmp_path,
                                                monkeypatch, case):
    """python -m ...datasets.{penn_action,h36m,insta_variety} with
    --resnet_ckpt and --device cpu: the extractor is built from the
    checkpoint on that device, and the train records carry its phis."""
    from human_dynamics_tpu_torch.data.schema import parse_temporal_example
    from human_dynamics_tpu_torch.datasets import phi_extractor

    make, _ = CONVERTERS[{"penn_action": "penn_train", "h36m": "h36m_train",
                          "insta_variety": "insta_openpose"}[case]]
    raw, out = str(tmp_path / "raw"), str(tmp_path / "out")
    make(raw, frames[0])
    args = {"penn_action": ["--data_dir", raw],
            "h36m": ["--data_dir", raw],
            "insta_variety": ["--track_dir", os.path.join(raw, "tracks"),
                              "--frame_root", os.path.join(raw, "frames")]}
    monkeypatch.setattr(phi_extractor, "FeatureExtractor", _StubExtractor)
    monkeypatch.setattr(_StubExtractor, "made", [])
    monkeypatch.setattr(sys, "argv", [case] + args[case] + [
        "--out_dir", out, "--resnet_ckpt", "R.npz", "--device", "cpu"])
    {"penn_action": PP, "h36m": PH, "insta_variety": PI}[case].main()
    assert _StubExtractor.made == [("R.npz", "cpu")]
    shards = sorted(os.listdir(os.path.join(out, "train")))
    assert shards and all(s.endswith(".tfrecord") for s in shards)
    ex = parse_temporal_example(next(read_tfrecord(
        os.path.join(out, "train", shards[0]))))
    assert ex.phis.shape == (ex.n, 3) and np.abs(ex.phis).max() <= 1.0
    assert tuple(ex.image_shapes[0]) == (224, 224)


def test_reencode_records_byte_equal(frames, tmp_path):
    """A test record (JPEG frames) and a phi-only train record re-encoded
    by both packages: byte-equal shards; raw_u8 and frame-less examples
    pass through; a rerun skips the existing shard."""
    from human_dynamics_tpu_torch.data.schema import (
        convert_to_example_temporal,
        parse_temporal_example,
    )
    from human_dynamics_tpu_torch.data.tfrecord import TFRecordWriter

    _, paths, _ = frames
    src = tmp_path / "src"
    src.mkdir()
    PTR.save_seq_to_test_tfrecord(str(src / "a.tfrecord"), paths[:12],
                                  [_walk_kps(12)])
    with TFRecordWriter(str(src / "b.tfrecord")) as w:
        w.write(convert_to_example_temporal(
            image_datas=None, image_paths=paths[:4],
            image_shapes=np.full((4, 2), 224), labels=np.zeros((4, 3, 25)),
            centers=np.zeros((4, 2)), gt3ds=None,
            scale_factors=np.ones(4), start_pts=np.zeros((4, 2)), cams=None,
            phis=np.random.RandomState(16).randn(4, 8)))
    assert JRe.reencode_dir(str(src), str(tmp_path / "j")) == 2
    assert PRe.reencode_dir(str(src), str(tmp_path / "p")) == 2
    got = _tree_bytes(str(tmp_path / "p"))
    assert got == _tree_bytes(str(tmp_path / "j"))
    serialized = next(read_tfrecord(str(tmp_path / "p" / "a.tfrecord")))
    raw = parse_temporal_example(serialized)
    assert raw.image_format == b"raw_u8"
    assert [len(d) for d in raw.image_datas] == [224 * 224 * 3] * 12
    assert PRe.reencode_example(serialized) == serialized
    assert PRe.reencode_dir(str(src), str(tmp_path / "p")) == 0
    PRe.main(["--src", str(src / "a.tfrecord"),
              "--dst", str(tmp_path / "one.tfrecord")])
    with open(tmp_path / "one.tfrecord", "rb") as f:
        assert f.read() == got["a.tfrecord"]
    with pytest.raises(FileNotFoundError):
        PRe.reencode_dir(str(tmp_path / "empty"), str(tmp_path / "x"))


@pytest.mark.parametrize("n", [0, 9, 255, 256, 257, 4096 + 3, 70001])
def test_crc32c_lanes_matches_bytewise(n, tmp_path, monkeypatch):
    """The numpy CRC-32C (records written where google_crc32c is not
    installed) equals the per-byte table loop, which gives the standard
    check value; a record framed with it equals one framed with the
    default CRC."""
    from human_dynamics_tpu_torch.data import tfrecord as T
    from human_dynamics_tpu_torch.data.tfrecord import TFRecordWriter

    assert T.crc32c_bytewise(b"123456789") == 0xE3069283
    data = np.random.RandomState(n).randint(0, 256, n, np.uint8).tobytes()
    assert T.crc32c_lanes(data) == T.crc32c_bytewise(data)
    paths = []
    for name, crc in (("default", T._crc32c), ("lanes", T.crc32c_lanes)):
        monkeypatch.setattr(T, "_crc32c", crc)
        paths.append(str(tmp_path / name))
        with TFRecordWriter(paths[-1]) as w:
            w.write(data)
        assert list(read_tfrecord(paths[-1], check_crc=True)) == [data]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_mocap_records_byte_equal(tmp_path):
    """write_mocap_records (shuffled pairs, 2 shards, S9 excluded) and
    write_mocap_temporal_records byte-equal; the shards read by the
    port's MocapStream."""
    rng = np.random.RandomState(17)
    for sub in ("CMU", "neutrSMPL_CMU"):
        d = tmp_path / "mosh" / sub
        d.mkdir(parents=True)
        for name in ("seq1", "S9_seq", "seq2"):
            np.savez(str(d / f"{name}.npz"),
                     poses=rng.randn(230, 75).astype(np.float32),
                     betas=rng.randn(16).astype(np.float32))
    mosh = str(tmp_path / "mosh")
    for name, kw in (("flat", dict(pairs_per_shard=600)), ("temporal", {})):
        fn = ("write_mocap_records" if name == "flat"
              else "write_mocap_temporal_records")
        want = getattr(JM, fn)(mosh, str(tmp_path / "j" / name), "CMU", **kw)
        got = getattr(PM, fn)(mosh, str(tmp_path / "p" / name), "CMU", **kw)
        assert [os.path.basename(p) for p in got] == [
            os.path.basename(p) for p in want]
    assert _tree_bytes(str(tmp_path / "p")) == _tree_bytes(
        str(tmp_path / "j"))
    shards = sorted((tmp_path / "p" / "flat").iterdir())
    assert len(shards) == 2
    assert sum(1 for s in shards for _ in read_tfrecord(str(s))) == 4 * 230
    pose, shape = next(iter(MocapStream([str(s) for s in shards])))
    assert pose.shape == (72,) and shape.shape == (10,)


@pytest.mark.parametrize("dataset", ["penn", "tdpw", "h36m"])
def test_joint_mappings_equal(dataset):
    """The joint maps and name tables into the universal 25."""
    if dataset == "penn":
        assert PP.get_upenn2coco() == JP.get_upenn2coco()
        assert PP.UPENN_JOINT_NAMES == JP.UPENN_JOINT_NAMES
    elif dataset == "tdpw":
        assert PT.get_3dpw2coco() == JT.get_3dpw2coco()
        assert PT.COCO18_JOINT_NAMES == JT.COCO18_JOINT_NAMES
    else:
        assert PH.H36M_TO_LSP14 == JH.H36M_TO_LSP14
        assert (PR.JOINT_SUBSET_17, PR.SUBSET17_TO_LSP14,
                PR.ACTION_NAMES) == (JR.JOINT_SUBSET_17,
                                     JR.SUBSET17_TO_LSP14, JR.ACTION_NAMES)
        kps = np.random.RandomState(18).randn(5, 14, 3)
        np.testing.assert_array_equal(PH.lsp14_to_coco25(kps),
                                      JH.lsp14_to_coco25(kps))
        poses = np.random.RandomState(19).randn(5, 32, 3)
        np.testing.assert_array_equal(PR.poses_to_lsp14(poses),
                                      JR.poses_to_lsp14(poses))
    assert PC.COCO25_JOINT_NAMES == JC.COCO25_JOINT_NAMES
    assert PI.UNIVERSAL_25_NAMES == JI.UNIVERSAL_25_NAMES


def test_rectify_joints_matches_jax():
    rng = np.random.RandomState(20)
    for _ in range(5):
        joints = rng.randn(25, 3)
        r = JR.euler_xyz_to_rotation(rng.randn(3))
        np.testing.assert_allclose(PT.rectify_joints(joints, r),
                                   JT.rectify_joints(joints, r),
                                   rtol=0, atol=1e-12)


def _metadata(path, rng):
    tokens = rng.randn(4 * 11 * 6 + 4 * 9)
    for cam in range(4):
        i = 4 * 11 * 6 + cam * 9
        tokens[i:i + 9] = [1100, 1100, 512, 512, -0.2, 0.05, -0.001, 0.001,
                           -0.002]
    root = ET.Element("root")
    ET.SubElement(root, "w0").text = "[" + " ".join(
        f"{t:.10g}" for t in tokens) + "]"
    mapping = ET.SubElement(root, "mapping")
    for row in (["not", "a", "row"],
                ["2", "1"] + [f"Walking {s}" for s in range(1, 12)]):
        tr = ET.SubElement(mapping, "tr")
        for cell in row:
            ET.SubElement(tr, "td").text = cell
    ET.ElementTree(root).write(path)
    return tokens


def test_h36m_raw_metadata_and_convert_match_jax(tmp_path):
    """metadata.xml's cameras and action table, the distorted projection,
    and convert_raw on a synthetic release (npy pose stand-ins, mp4
    videos): the same sequence directories, frames byte-equal, arrays
    equal."""
    import cv2

    rng = np.random.RandomState(21)
    raw = tmp_path / "raw"
    s_dir = raw / "S1"
    for sub in ("Videos", "MyPoseFeatures/D2_Positions",
                "MyPoseFeatures/D3_Positions_mono"):
        (s_dir / sub).mkdir(parents=True)
    tokens = _metadata(str(raw / "metadata.xml"), rng)
    xml = str(raw / "metadata.xml")
    np.testing.assert_array_equal(PR.read_cameras_metadata(xml),
                                  JR.read_cameras_metadata(xml))
    assert PR.action_name_map(xml) == JR.action_name_map(xml)
    for s, c in ((1, 1), (3, 2), (11, 4)):
        got = PR.camera_parameters(tokens, s, c)
        want = JR.camera_parameters(tokens, s, c)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = 12
    for cam in (1, 2):
        pose3d = rng.randn(n, 32, 3) * 150 + np.array([0, 0, 4000.0])
        p = JR.camera_parameters(tokens, 1, cam)
        args = (np.eye(3), np.zeros(3), p["focal"], p["principal"],
                p["k_radial"], p["p_tangential"])
        pose2d = PR.project_points(pose3d, *args)
        np.testing.assert_array_equal(pose2d, JR.project_points(pose3d,
                                                                *args))
        np.save(s_dir / "MyPoseFeatures/D2_Positions" /
                f"Walking 1.cam{cam}.npy",
                pose2d.reshape(1, n, 64).astype(np.float32))
        np.save(s_dir / "MyPoseFeatures/D3_Positions_mono" /
                f"Walking 1.cam{cam}.npy",
                pose3d.reshape(1, n, 96).astype(np.float32))
        w = cv2.VideoWriter(str(s_dir / "Videos" / f"Walking 1.cam{cam}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        for i in range(n):
            w.write(np.full((48, 64, 3), i * 10, np.uint8))
        w.release()
    kw = dict(subjects=(1,), frame_skip=2, cameras=(1, 2))
    want = JR.convert_raw(str(raw), str(tmp_path / "j"), **kw)
    got = PR.convert_raw(str(raw), str(tmp_path / "p"), **kw)
    assert [os.path.relpath(d, tmp_path / "p") for d in got] == [
        os.path.relpath(d, tmp_path / "j") for d in want]
    assert len(got) == 2
    jt, pt = _tree_bytes(str(tmp_path / "j")), _tree_bytes(
        str(tmp_path / "p"))
    assert sorted(pt) == sorted(jt)
    for name in jt:
        if name.endswith(".npz"):
            continue
        assert pt[name] == jt[name], name
    for d_p, d_j in zip(got, want):
        cp, cj = (np.load(os.path.join(d, "camera.npz")) for d in (d_p, d_j))
        assert sorted(cp.files) == sorted(cj.files)
        for k in cj.files:
            np.testing.assert_array_equal(cp[k], cj[k])
        assert PR.reprojection_error(d_p) == JR.reprojection_error(d_j)
    assert PR.convert_raw(str(raw), str(tmp_path / "p"), **kw) == got


@pytest.mark.parametrize("backend", ["npy", "npz", "spacepy", "cdflib",
                                     "none"])
def test_read_pose_file_matches_jax(backend, monkeypatch, tmp_path):
    """The .npy / .npz stand-ins and the CDF branches (stub spacepy and
    cdflib modules in sys.modules) read the same arrays; with neither
    module both raise ImportError."""
    arr = np.random.RandomState(22).rand(1, 5, 96)
    path = str(tmp_path / f"pose.{backend if backend[0] == 'n' else 'cdf'}")
    if backend == "npy":
        np.save(path, arr)
    elif backend == "npz":
        np.savez(path, Pose=arr)

    class FakeCDF:
        def __init__(self, p):
            assert p == path

        def __enter__(self):
            return {"Pose": arr}

        def __exit__(self, *exc):
            return False

        def varget(self, name):
            assert name == "Pose"
            return arr

    pycdf = types.ModuleType("spacepy.pycdf")
    pycdf.CDF = FakeCDF
    spacepy = types.ModuleType("spacepy")
    spacepy.pycdf = pycdf
    cdflib = types.ModuleType("cdflib")
    cdflib.CDF = FakeCDF
    monkeypatch.setitem(sys.modules, "spacepy",
                        spacepy if backend == "spacepy" else None)
    monkeypatch.setitem(sys.modules, "spacepy.pycdf", pycdf)
    monkeypatch.setitem(sys.modules, "cdflib",
                        cdflib if backend == "cdflib" else None)
    if backend == "none":
        for mod in (PR, JR):
            with pytest.raises(ImportError, match="spacepy or cdflib"):
                mod.read_pose_file(path, dim=3)
        return
    got = PR.read_pose_file(path, dim=3)
    assert got.shape == (5, 32, 3)
    np.testing.assert_array_equal(got, JR.read_pose_file(path, dim=3))


def test_insta_detect_and_track_and_split_match_jax(tmp_path):
    """The shot_split per-frame layout (joints by name, the 0.1 logit
    threshold, Head invisible, imloc frames) gives the same tubes; the
    video-list split and the PoseFlow-dict tracks equal."""
    import json

    rng = np.random.RandomState(23)
    root = tmp_path / "dt"
    for code in ("vidA", "vidB"):
        for seq in ("000", "001"):
            d = root / code / "shot_split" / seq
            d.mkdir(parents=True)
            for i in range(N + (5 if seq == "001" else 0)):
                data = {"imloc": f"frame_{i:05d}.jpg"}
                for j, name in enumerate(PI.UNIVERSAL_25_NAMES):
                    if j != 7:
                        data[name] = {"x": float(rng.rand() * 300),
                                      "y": float(rng.rand() * 200),
                                      "logits": float(rng.rand())}
                (d / f"{i:05d}.json").write_text(json.dumps(data))
    kw = dict(num_copies=2)
    for codes in (None, ["vidB"]):
        want = list(JI.gather_tubes_detect_and_track(
            str(root), "/frames", video_codes=codes, **kw))
        got = list(PI.gather_tubes_detect_and_track(
            str(root), "/frames", video_codes=codes, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["image_paths"] == w["image_paths"]
            np.testing.assert_array_equal(g["gt2ds"], w["gt2ds"])

    lst = tmp_path / "codes.txt"
    lst.write_text("".join(f"v{i}\n" for i in range(2500)))
    for split in ("train", "test"):
        assert (PI.split_video_codes(str(lst), split)
                == JI.split_video_codes(str(lst), split))
    for mod in (PI, JI):
        with pytest.raises(ValueError):
            mod.split_video_codes(str(lst), "val")

    kps = _walk_kps(30, seed=24)
    poseflow = {f"frame{i:04d}.jpg": [{"keypoints": kps[i].ravel().tolist(),
                                       "idx": 1}] for i in range(30)}
    path = tmp_path / "poseflow.json"
    path.write_text(json.dumps(poseflow))
    got, want = PI.load_track_json(str(path)), JI.load_track_json(str(path))
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_visualize_record_matches_jax(frames, tmp_path):
    """Skeleton overlays of a test record (224 crops) and of a train
    record that keeps its 300 crops: the same PNG files, byte-equal; a
    phi-only record writes none."""
    from human_dynamics_tpu_torch.datasets.tube_writer import TubeConverter

    _, paths, _ = frames
    test_rec = str(tmp_path / "test.tfrecord")
    PTR.save_seq_to_test_tfrecord(test_rec, paths[:12], [_walk_kps(12)])
    train_rec, = TubeConverter(str(tmp_path / "train"), save_img=True,
                               ).write_tubes("t", [dict(
                                   image_paths=paths[:12],
                                   gt2ds=_walk_kps(12))])
    bare_rec, = TubeConverter(str(tmp_path / "bare")).write_tubes(
        "t", [dict(image_paths=paths[:12], gt2ds=_walk_kps(12))])
    for rec, is_test, count in ((test_rec, True, 12), (train_rec, False, 12),
                                (bare_rec, False, 0)):
        out_p, out_j = str(tmp_path / "vp"), str(tmp_path / "vj")
        got = PV.visualize_record(rec, out_p, max_frames=12, is_test=is_test)
        want = JV.visualize_record(rec, out_j, max_frames=12, is_test=is_test)
        assert len(got) == len(want) == count
        for g, w in zip(got, want):
            assert os.path.basename(g) == os.path.basename(w)
            with open(g, "rb") as fg, open(w, "rb") as fw:
                assert fg.read() == fw.read(), g


def test_insta_download_with_a_fake_downloader(tmp_path, monkeypatch):
    """A fake yt-dlp on PATH: both packages download the same entries,
    skip those present, count a failure out; without a downloader both
    raise."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "yt-dlp"
    fake.write_text(
        "#!/bin/sh\n"
        'case "$3" in *bad*) exit 1;; esac\n'
        'echo "$3" > "$2"\n')
    fake.chmod(0o755)
    entries = [{"url": "https://v/a1", "id": "a1"}, "https://v/b2",
               {"url": "https://v/bad", "id": "c3"}, "https://v/d4/"]
    listing = tmp_path / "insta.json"
    listing.write_text(__import__("json").dumps(entries))
    monkeypatch.setenv("PATH", str(bin_dir))
    for name, mod in (("p", PD), ("j", JD)):
        out = tmp_path / name
        out.mkdir()
        (out / "d4.mp4").write_text("present")
        assert mod.download(str(listing), str(out)) == 3
    assert _tree_bytes(str(tmp_path / "p")) == _tree_bytes(str(tmp_path /
                                                             "j"))
    assert sorted(os.listdir(tmp_path / "p")) == ["a1.mp4", "b2.mp4",
                                                  "d4.mp4"]
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    for mod in (PD, JD):
        with pytest.raises(FileNotFoundError):
            mod.downloader_binary()


def test_autorestart_retries_until_success(tmp_path, monkeypatch):
    """A command that fails twice: both packages run it three times and
    return 0; with max_tries=1 they return its failing code."""
    monkeypatch.setattr(PA.time, "sleep", lambda s: None)
    monkeypatch.setattr(JA.time, "sleep", lambda s: None)
    for name, mod in (("p", PA), ("j", JA)):
        counter = tmp_path / f"{name}.count"
        cmd = [sys.executable, "-c",
               "import sys; p = sys.argv[1]\n"
               "try: n = int(open(p).read())\n"
               "except OSError: n = 0\n"
               "open(p, 'w').write(str(n + 1)); sys.exit(0 if n >= 2 else 3)",
               str(counter)]
        assert mod.restart_until_success(cmd, backoff=0) == 0
        assert counter.read_text() == "3"
        counter.unlink()
        assert mod.restart_until_success(cmd, max_tries=1) == 3
