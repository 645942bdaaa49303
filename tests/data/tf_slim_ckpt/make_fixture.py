"""Write the TF-slim checkpoint fixture of this directory with TensorFlow.

    python tests/data/tf_slim_ckpt/make_fixture.py

A phi-mode HmmrModel of the port (include_resnet=False, feature_dim=32,
num_conv_layers=3, delta_t_values=(), do_hallucinate=True; weights from
torch seed 21; 5 MB, most of it the IEF's fixed 1024-wide layers) under
the reference's slim variable names (``export_to_slim_names``), plus an
int64 ``global_step`` of 1, saved the way the reference saved its
checkpoints (a graph-mode ``tf.compat.v1.train.Saver``):

- ``model.ckpt-1``: every variable, one data shard;
- ``sharded/model.ckpt-1``: every variable but ``single_view_ief/*``, over
  two data shards (``Saver(sharded=True)``, the variables placed on two
  CPU devices).

Each directory's ``checkpoint`` state file names its prefix by a relative
path. ``chip_smoke.py`` (phase 21) and ``tests/test_torch_tf_checkpoint.py``
read them with ``human_dynamics_tpu_torch.utils.tf_bundle``.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))

from human_dynamics_tpu_torch.models import HmmrModel  # noqa: E402
from human_dynamics_tpu_torch.utils.checkpoint import (  # noqa: E402
    export_to_slim_names,
)
from human_dynamics_tpu_torch.utils.weights import (  # noqa: E402
    export_jax_variables,
)

SLIM_KW = dict(include_resnet=False, num_conv_layers=3, delta_t_values=(),
               do_hallucinate=True)
FEATURE_DIM = 32


def slim_variables():
    """{slim name: float32 array} of the fixture's model."""
    model = HmmrModel(feature_dim=FEATURE_DIM, **SLIM_KW,
                      generator=torch.Generator().manual_seed(21))
    return export_to_slim_names(export_jax_variables(model), **SLIM_KW)


def main():
    import tensorflow as tf

    tf1 = tf.compat.v1
    slim = slim_variables()
    graph = tf.Graph()
    with graph.as_default():
        variables = {}
        for name, value in sorted(slim.items()):
            device = "/cpu:0" if name.startswith(
                ("single_view_ief", "AZ_FC")) else "/cpu:1"
            with tf.device(device):
                variables[name] = tf1.get_variable(
                    name, initializer=tf.constant(value))
        with tf.device("/cpu:1"):
            variables["global_step"] = tf1.get_variable(
                "global_step", initializer=tf.constant(1, tf.int64))
        whole = tf1.train.Saver(variables, save_relative_paths=True)
        part = tf1.train.Saver(
            {k: v for k, v in variables.items()
             if not k.startswith("single_view_ief/")},
            sharded=True, save_relative_paths=True)
        config = tf1.ConfigProto(device_count={"CPU": 2})
        with tf1.Session(config=config) as sess:
            sess.run(tf1.global_variables_initializer())
            for saver, sub in ((whole, ""), (part, "sharded")):
                d = os.path.join(HERE, sub)
                os.makedirs(d, exist_ok=True)
                print(saver.save(sess, os.path.join(d, "model.ckpt"),
                                 global_step=1, write_meta_graph=False))


if __name__ == "__main__":
    main()
