"""The port's TF checkpoint reader (human_dynamics_tpu_torch.utils.tf_bundle)
against TensorFlow's, and its TF-slim converter against the JAX package's.

A module fixture writes graph-mode ``Saver`` checkpoints with TensorFlow
once: a phi-mode HmmrModel (feature_dim 32) under the reference's slim
names with a discriminator and one variable of each other dtype the reader
takes, in one data shard and in two; the plain-HMR layout (the IEF without
its ``single_view_ief/`` scope); and one with a partitioned and a string
variable, which the reader refuses. The committed fixture of
``tests/data/tf_slim_ckpt`` (``chip_smoke.py`` phase 21) is read too.

Every variable reads bit-equal to ``tf.train.load_checkpoint``; the
converter's and ``export_to_slim_names``'s trees equal the JAX package's
leaf for leaf; the port model loaded from the converted tree gives the JAX
model's omegas within rtol 1e-5 (atol 1e-6 for elements near 0: float32
sums in another order).
"""

import os
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu.models.hmmr import HmmrModel as JaxHmmr
from human_dynamics_tpu.utils import checkpoint as JC
from human_dynamics_tpu_torch.data.tfrecord import masked_crc32c
from human_dynamics_tpu_torch.eval.harness import load_model_variables
from human_dynamics_tpu_torch.models import HmmrModel, PoseDiscriminator
from human_dynamics_tpu_torch.utils import checkpoint as PC
from human_dynamics_tpu_torch.utils import tf_bundle
from human_dynamics_tpu_torch.utils.weights import (
    export_jax_variables,
    load_jax_variables,
)

torch.set_num_threads(1)

FEATURE = 32
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "tf_slim_ckpt")
EXTRA = {                      # one variable of each other dtype
    "extra/half": np.linspace(-2, 2, 7).astype(np.float16),
    "extra/double": np.linspace(-1, 1, 5),
    "extra/int32": np.arange(-3, 3, dtype=np.int32).reshape(2, 3),
    "extra/uint8": np.arange(250, 256, dtype=np.uint8),
    "extra/bool": np.array([True, False, True]),
}


def _variables():
    """A flax variables tree of the phi-mode model (numpy leaves, exported
    from a seeded port model; biases, norms and mean_param randomised)."""
    model = HmmrModel(include_resnet=False, feature_dim=FEATURE,
                      generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)

    def randomise(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomise(v)
            elif k in ("bias", "scale", "mean_param"):
                tree[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        return tree

    return randomise(export_jax_variables(model))


def _disc_slim(rng, hidden=32, nz=64):
    """D_pose/* of a narrow discriminator, in the reference's layouts."""
    out = {
        "D_pose/D_conv1/weights": rng.randn(1, 1, 9, hidden),
        "D_pose/D_conv1/biases": rng.randn(hidden),
        "D_pose/D_conv2/weights": rng.randn(1, 1, hidden, hidden),
        "D_pose/D_conv2/biases": rng.randn(hidden),
        "D_pose/D_alljoints_fc1/weights": rng.randn(23 * hidden, nz),
        "D_pose/D_alljoints_fc1/biases": rng.randn(nz),
        "D_pose/D_alljoints_fc2/weights": rng.randn(nz, nz),
        "D_pose/D_alljoints_fc2/biases": rng.randn(nz),
        "D_pose/D_alljoints_out/weights": rng.randn(nz, 1),
        "D_pose/D_alljoints_out/biases": rng.randn(1),
    }
    for j in range(23):
        out[f"D_pose/pose_out_j{j}/weights"] = rng.randn(hidden, 1)
        out[f"D_pose/pose_out_j{j}/biases"] = rng.randn(1)
    return {k: (0.1 * v).astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """TensorFlow, {name: checkpoint prefix} written once with it, and the
    model variables they hold."""
    with pytest.MonkeyPatch.context() as mp:
        # TensorFlow imports Keras 3 when it is imported (seconds); the
        # legacy tf_keras it imports instead costs less. No Keras is used.
        mp.setenv("TF_USE_LEGACY_KERAS", "1")
        tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    variables = _variables()
    hmmr = JC.export_to_slim_names(variables, include_resnet=False)
    hmmr.update(_disc_slim(np.random.RandomState(2)))
    hmmr.update(EXTRA)
    root = tmp_path_factory.mktemp("tf_ckpt")
    graph = tf.Graph()
    with graph.as_default():
        tv = {}
        for i, (name, value) in enumerate(sorted(hmmr.items())):
            with tf.device(f"/cpu:{i % 2}"):
                tv[name] = tf1.get_variable(name,
                                            initializer=tf.constant(value))
        with tf.device("/cpu:0"):
            tv["global_step"] = tf1.train.get_or_create_global_step()
        hmr = {k.replace("single_view_ief/", "", 1): v for k, v in tv.items()
               if not k.startswith(("D_pose/", "extra/"))}
        part = tf1.get_variable(
            "part", [4, 3], tf.float64, tf1.zeros_initializer(),
            partitioner=tf1.fixed_size_partitioner(2))
        text = tf1.Variable([b"a", b"b"], name="text")
        savers = {
            "hmmr": tf1.train.Saver(tv),
            "hmmr_sharded": tf1.train.Saver(tv, sharded=True),
            "hmr": tf1.train.Saver(hmr),
            "refused": tf1.train.Saver([part, text]),
        }
        paths = {}
        config = tf1.ConfigProto(device_count={"CPU": 2})
        with tf1.Session(config=config) as sess:
            sess.run(tf1.global_variables_initializer())
            for name, saver in savers.items():
                (root / name).mkdir()
                paths[name] = saver.save(sess, str(root / name / "model.ckpt"),
                                         write_meta_graph=False)
    return tf, paths, variables


def _bit_equal(got, want, what):
    want = np.asarray(want)
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


@pytest.mark.parametrize(
    "name", ["hmmr", "hmmr_sharded", "hmr", "fixture", "fixture_sharded"])
def test_bundle_reads_bit_equal_to_tf(ckpts, name):
    """Every variable, by prefix and through the directory's checkpoint
    state file; 1 and 2 data shards; float32, float16, float64, int32,
    int64 (global_step), uint8 and bool."""
    tf, paths, _ = ckpts
    if name.startswith("fixture"):
        directory = (os.path.join(FIXTURE, "sharded")
                     if name == "fixture_sharded" else FIXTURE)
        prefix = tf_bundle.latest_checkpoint(directory)
        assert prefix == os.path.join(directory, "model.ckpt-1")
    else:
        prefix = paths[name]
        directory = os.path.dirname(prefix)
    want = tf.train.load_checkpoint(prefix)
    shapes = want.get_variable_to_shape_map()
    for path in (prefix, directory):
        got = tf_bundle.load_checkpoint(path)
        assert got.get_variable_to_shape_map() == shapes
        for var in shapes:
            _bit_equal(got.get_tensor(var), want.get_tensor(var), var)
    shards = len([f for f in os.listdir(directory) if ".data-" in f])
    assert shards == (2 if name.endswith("sharded") else 1)
    if name.startswith("hmmr"):
        dtypes = {np.asarray(want.get_tensor(v)).dtype for v in shapes}
        assert len(dtypes) == len(EXTRA) + 2       # + float32 and int64


def _assert_trees_equal(got, want):
    got, want = PC.flatten_tree(got), JC.flatten_tree(want)
    assert set(got) == set(want)
    for k in want:
        _bit_equal(np.asarray(got[k]), want[k], k)


@pytest.mark.parametrize("name", ["hmmr", "hmmr_sharded", "hmr"])
def test_convert_tf_checkpoint_matches_jax(ckpts, name):
    """The port's converter (and the CLIs' load_model_variables) against
    JAX's, strict, leaf for leaf; the discriminator's tree too where
    D_pose/* is present."""
    _, paths, _ = ckpts
    kw = dict(include_resnet=False, strict=True)
    got = PC.convert_tf_checkpoint(paths[name], **kw)
    want = JC.convert_tf_checkpoint(paths[name], **kw)
    pair = name != "hmr"               # D_pose/* present: (hmmr, disc)
    assert isinstance(got, tuple) == isinstance(want, tuple) == pair
    if not pair:
        got, want = (got, None), (want, None)
    _assert_trees_equal(got[0], want[0])
    if pair:
        _assert_trees_equal(got[1], want[1])
    _assert_trees_equal(load_model_variables(paths[name]), want[0])


def test_tf_checkpoint_model_matches_jax(ckpts):
    """The port's HmmrModel and discriminator load the converted trees
    strictly; the model's omegas equal the JAX model's on its own
    conversion of the same checkpoint."""
    _, paths, _ = ckpts
    hmmr, disc = PC.convert_tf_checkpoint(paths["hmmr"], include_resnet=False)
    jax_hmmr, _ = JC.convert_tf_checkpoint(paths["hmmr"], include_resnet=False)
    model = HmmrModel(include_resnet=False, feature_dim=FEATURE, device="meta")
    load_jax_variables(model.to_empty(device="cpu"), hmmr).eval()
    load_jax_variables(
        PoseDiscriminator(nz_feat=64, device="meta").to_empty(device="cpu"),
        disc)
    phi = np.random.RandomState(3).randn(2, 20, FEATURE).astype(np.float32)
    jax_model = JaxHmmr(include_resnet=False, feature_dim=FEATURE)
    want = jax.jit(jax_model.apply)(jax_hmmr, jnp.asarray(phi))
    with torch.no_grad():
        got = model(torch.from_numpy(phi))
    np.testing.assert_allclose(got.omega_pred.numpy(),
                               np.asarray(want.omega_pred),
                               rtol=1e-5, atol=1e-6)
    for dt, omegas in want.omegas_delta.items():
        np.testing.assert_allclose(got.omegas_delta[dt].numpy(),
                                   np.asarray(omegas), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tree", ["phi_model", "every_slim_name"])
def test_export_to_slim_names_matches_jax(ckpts, tree):
    """export_to_slim_names on the phi-mode model's tree, and on a tree
    holding a leaf at every path of the full name map (ResNet included)."""
    _, _, variables = ckpts
    if tree == "phi_model":
        kw = dict(include_resnet=False)
    else:
        rng = np.random.RandomState(4)
        variables = {}
        for name, (coll, path) in JC.slim_to_flax_name_map().items():
            node = variables.setdefault(coll, {})
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = rng.randn(3, 2).astype(np.float32)
        kw = {}
    got = PC.export_to_slim_names(variables, **kw)
    want = JC.export_to_slim_names(variables, **kw)
    assert list(got) == list(want)
    for k in want:
        _bit_equal(got[k], want[k], k)


def _block0(index: bytes):
    """(offset, size) of the index file's first data block."""
    footer = index[-48:]
    pos = 0
    for _ in range(2):                                   # metaindex handle
        _, pos = tf_bundle._varint(footer, pos)
    offset, pos = tf_bundle._varint(footer, pos)
    size, _ = tf_bundle._varint(footer, pos)
    (_, handle), = tf_bundle._block_entries(index[offset:offset + size], "")
    offset, pos = tf_bundle._varint(handle, 0)
    return offset, tf_bundle._varint(handle, pos)[0]


def _reseal(index: bytearray, offset: int, size: int) -> None:
    """Recompute a block's trailer CRC after an edit."""
    crc = masked_crc32c(bytes(index[offset:offset + size + 1]))
    index[offset + size + 1:offset + size + 5] = struct.pack("<I", crc)


@pytest.mark.parametrize("case", [
    "flipped_data", "bad_magic", "block_crc", "compressed", "big_endian",
    "missing_shard", "sliced", "string"])
def test_refused_bundles_raise(ckpts, tmp_path, case):
    """A corrupted copy of the committed fixture, and the variables the
    reader does not take, raise BundleError; nothing partial is returned."""
    _, paths, _ = ckpts
    if case in ("sliced", "string"):
        reader = tf_bundle.load_checkpoint(paths["refused"])
        var = "part" if case == "sliced" else "text"
        with pytest.raises(tf_bundle.BundleError, match=case):
            reader.get_tensor(var)
        return
    d = str(tmp_path / "ckpt")
    shutil.copytree(FIXTURE, d)
    prefix = os.path.join(d, "model.ckpt-1")
    index = bytearray(open(prefix + ".index", "rb").read())
    offset, size = _block0(bytes(index))
    if case == "flipped_data":
        data = prefix + ".data-00000-of-00001"
        raw = bytearray(open(data, "rb").read())
        raw[len(raw) // 2] ^= 0x01
        open(data, "wb").write(raw)
        match = "CRC mismatch in"
    elif case == "bad_magic":
        index[-1] ^= 0xFF
        match = "magic"
    elif case == "block_crc":
        index[offset + 3] ^= 0x01
        match = "CRC mismatch in the block"
    elif case == "compressed":
        index[offset + size] = 1                    # snappy
        _reseal(index, offset, size)
        match = "compressed"
    elif case == "big_endian":
        # The header {num_shards: 1, version: {producer: 1}} rewritten in
        # place as {num_shards: 1, endianness: BIG, version: {}}.
        assert bytes(index[offset:offset + 9]).hex() == "000006080" \
            "11a020801"
        index[offset + 3:offset + 9] = bytes.fromhex("080110011a00")
        _reseal(index, offset, size)
        match = "big-endian"
    else:
        prefix = os.path.join(d, "sharded", "model.ckpt-1")
        os.remove(prefix + ".data-00001-of-00002")
        match = "missing data shard"
    open(os.path.join(d, "model.ckpt-1.index"), "wb").write(index)
    with pytest.raises(tf_bundle.BundleError, match=match):
        PC.convert_tf_checkpoint(prefix, include_resnet=False,
                                 delta_t_values=())
