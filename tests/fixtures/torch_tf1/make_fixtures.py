"""Write the TF1 MetaGraphDef JSON fixtures of this directory.

The reference's three example models, built with ``tf.compat.v1`` at their
published widths and exported as ``json_format.MessageToJson(
tf.train.export_meta_graph())`` — the reference's ``build_graph`` wire
format (``sparkflow/graph_utils.py:6-15``):

- ``mnist_mlp.json``: ``examples/simple_dnn.py``, 784 -> 256 -> 256 -> 10,
  ``out`` = argmax, softmax cross entropy;
- ``mnist_cnn.json``: ``examples/cnn_example.py``, conv 32x5 -> max-pool 2
  -> conv 64x3 -> max-pool 2 -> dense 10 (VALID padding, as
  ``tf.layers``' default), ``out`` = argmax;
- ``autoencoder.json``: ``examples/autoencoder_example.py``, 784 -> 256 ->
  128 (``out/Sigmoid``) -> 256 -> 784, mean squared error against the input.
- ``tf1_migration.json``: the MetaGraphDef of
  ``sparkflow_tpu_torch/examples/tf1_migration.py``'s
  ``make_legacy_artifacts`` (2 -> 12 relu -> 1, ``out_act`` = sigmoid, log
  loss), which that example trains from on a machine without TensorFlow.

Layers are built from ``get_variable`` + ``matmul`` / ``conv2d`` with glorot
kernels and zero biases (``tf.layers`` is gone under Keras 3); the JSON
carries the initializer subgraphs, not weights. Needs TensorFlow; run from
the repository root: ``python tests/fixtures/torch_tf1/make_fixtures.py``.
"""

import os

import tensorflow as tf
from google.protobuf import json_format

tf1 = tf.compat.v1
tf1.disable_eager_execution()

HERE = os.path.dirname(os.path.abspath(__file__))


def _vars(name, kshape, units):
    with tf1.variable_scope(name):
        k = tf1.get_variable("kernel", kshape,
                             initializer=tf1.glorot_uniform_initializer())
        b = tf1.get_variable("bias", [units],
                             initializer=tf1.zeros_initializer())
    return k, b


def dense(x, units, name, act=None):
    k, b = _vars(name, [int(x.shape[-1]), units], units)
    y = tf1.nn.bias_add(tf1.matmul(x, k), b, name=name + "/BiasAdd")
    return act(y, name=name + "/" + act.__name__.capitalize()) if act else y


def conv(x, filters, size, name):
    k, b = _vars(name, [size, size, int(x.shape[-1]), filters], filters)
    y = tf1.nn.conv2d(x, k, strides=[1, 1, 1, 1], padding="VALID")
    return tf1.nn.relu(tf1.nn.bias_add(y, b), name=name + "/Relu")


def mnist_mlp():
    x = tf1.placeholder(tf.float32, [None, 784], name="x")
    y = tf1.placeholder(tf.float32, [None, 10], name="y")
    h = dense(x, 256, "dense", tf1.nn.relu)
    h = dense(h, 256, "dense_1", tf1.nn.relu)
    out = dense(h, 10, "dense_2")
    tf1.argmax(out, 1, name="out")
    tf1.losses.softmax_cross_entropy(y, out)


def mnist_cnn():
    x = tf1.placeholder(tf.float32, [None, 784], name="x")
    y = tf1.placeholder(tf.float32, [None, 10], name="y")
    xr = tf1.reshape(x, [-1, 28, 28, 1])
    c1 = conv(xr, 32, 5, "conv2d")
    p1 = tf1.nn.max_pool(c1, ksize=[1, 2, 2, 1], strides=[1, 2, 2, 1],
                         padding="VALID")
    c2 = conv(p1, 64, 3, "conv2d_1")
    p2 = tf1.nn.max_pool(c2, ksize=[1, 2, 2, 1], strides=[1, 2, 2, 1],
                         padding="VALID")
    flat = tf1.reshape(p2, [-1, 5 * 5 * 64])
    out = dense(flat, 10, "dense")
    tf1.argmax(out, 1, name="out")
    tf1.losses.softmax_cross_entropy(y, out)


def autoencoder():
    x = tf1.placeholder(tf.float32, [None, 784], name="x")
    h = dense(x, 256, "dense", tf1.nn.relu)
    h = dense(h, 128, "out", tf1.nn.sigmoid)
    h = dense(h, 256, "dense_1", tf1.nn.relu)
    rec = dense(h, 784, "dense_2", tf1.nn.sigmoid)
    tf1.losses.mean_squared_error(rec, x)


def export(build) -> str:
    g = tf1.Graph()
    with g.as_default():
        build()
        return json_format.MessageToJson(tf1.train.export_meta_graph())


if __name__ == "__main__":
    for name, build in (("mnist_mlp", mnist_mlp), ("mnist_cnn", mnist_cnn),
                        ("autoencoder", autoencoder)):
        path = os.path.join(HERE, name + ".json")
        with open(path, "w") as f:
            f.write(export(build))
        print(path, os.path.getsize(path))
    import sys
    import tempfile
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from sparkflow_tpu_torch.examples.tf1_migration import (
        make_legacy_artifacts)
    path = os.path.join(HERE, "tf1_migration.json")
    with tempfile.TemporaryDirectory() as tmp, open(path, "w") as f:
        f.write(make_legacy_artifacts(tmp)[0])
    print(path, os.path.getsize(path))
