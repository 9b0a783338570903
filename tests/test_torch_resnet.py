"""PyTorch port, ResNet: ``resnet`` / ``resnet50`` against the JAX
package's on the same numpy-drawn weights, at a narrow width (4 channels
at the stem), depths 18 (basic blocks) and 50 (bottlenecks), at image 32
(the CIFAR stem) and image 72 (the ImageNet stem: 7x7/2 padded (2, 3), a
3x3/2 ``SAME`` max-pool), plus the ``he_normal`` draw and the estimator.

The weights are drawn by numpy at the initializers' scales (a conv kernel
N(0, 2 / fan_in)). Tolerances: float32 logits 1e-4; one step's gradients
1e-5 absolute plus 1e-4 relative at depth 18, and at depth 50, where
float32 itself is the limit, against a float64 gradient as well (see the
test; with every kernel at N(0, 0.3) instead, both packages land ~0.08
from float64 at the stem, ~2 % of its largest entry); bfloat16 logits within 5e-2 of max |logit| (both sides round
every convolution's output and the residual stream to bf16, 8 bits of
mantissa, and the group norms renormalise in float32 between them). The
fitted estimator's probabilities, transformed by the JAX package's
``SparkAsyncDLModel``, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import numpy_params
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.models.registry import model_from_json as jax_from_json
from sparkflow_tpu.tensorflow_async import SparkAsyncDLModel as JaxModel
from sparkflow_tpu_torch.convert import (list_to_params, params_from_jax,
                                         params_to_list)
from sparkflow_tpu_torch.graphdef import initialize
from sparkflow_tpu_torch.localml import OneHotEncoder, Pipeline
from sparkflow_tpu_torch.models import (ResNet, ResNet50,
                                        build_registry_spec, model_from_json)
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 5e-2


def resnet_params(specs, seed):
    """``numpy_params`` with every ``he_normal`` kernel at its own scale,
    N(0, 2 / fan_in), fan_in = kh * kw * cin."""
    tree = numpy_params(specs, seed=seed, std=1.0)
    for ln, ps in specs.items():
        for pn, (shape, init) in ps.items():
            if init == "he_normal":
                fan_in = int(np.prod(shape[:-1]))
                tree[ln][pn] *= np.float32(np.sqrt(2.0 / fan_in))
    return tree


def _pair(depth, image, seed=1):
    cfg = dict(num_classes=5, depth=depth, image_size=image, width=4)
    spec = build_registry_spec("resnet", **cfg)
    assert spec == jax_spec("resnet", **cfg)
    jm = jax_from_json(spec)
    return jm, spec, resnet_params(jm.param_specs(), seed)


def _images(seed, b, image, flat=False):
    x = np.random.default_rng(seed).normal(size=(b, image, image, 3))
    x = x.astype(np.float32)
    return x.reshape(b, -1) if flat else x


CASES = [(18, 32), (18, 72), (50, 32), (50, 72)]


@pytest.mark.parametrize("depth,image", CASES)
def test_forward_matches_jax(depth, image):
    jm, spec, npp = _pair(depth, image)
    tm = model_from_json(spec, device="cpu")
    assert list(tm.param_specs().items()) == list(jm.param_specs().items())
    x = _images(depth + image, 2, image, flat=image == 32)
    want = jm.apply(jax.tree.map(jnp.asarray, npp), {"x": jnp.asarray(x)},
                    ["logits", "pred"])
    with torch.inference_mode():
        got = tm.apply(params_from_jax(tm, npp), {"x": torch.from_numpy(x)},
                       ["logits", "pred"])
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))


@pytest.mark.parametrize("depth,image", CASES)
def test_bf16_forward_matches_jax(depth, image):
    _, spec, npp = _pair(depth, image, seed=2)
    jm = jax_from_json(spec, compute_dtype=jnp.bfloat16)
    tm = model_from_json(spec, compute_dtype="bfloat16", device="cpu")
    x = _images(7, 2, image)
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, npp),
                               {"x": jnp.asarray(x)}, ["logits"])["logits"])
    with torch.inference_mode():
        got = tm.apply(params_from_jax(tm, npp), {"x": torch.from_numpy(x)},
                       ["logits"])["logits"]
    assert got.dtype == torch.float32            # the head runs in float32
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err


def _port_grads(spec, npp, x, y, dtype):
    tm = model_from_json(spec, device="cpu")
    tp = tm.load_params(params_from_jax(tm, npp, dtype=dtype),
                        trainable=True)
    loss = tm.loss_vector(tp, {"x": torch.from_numpy(x).to(dtype),
                               "y": torch.from_numpy(y)}).mean()
    names = [(ln, pn) for ln, ps in tm.param_specs().items() for pn in ps]
    grads = torch.autograd.grad(loss, [tp[ln][pn] for ln, pn in names])
    return float(loss.detach()), {n: g.double().numpy()
                                  for n, g in zip(names, grads)}


@pytest.mark.parametrize("depth,image", CASES)
def test_loss_and_gradients_match_jax(depth, image):
    """Depth 18 within 1e-5 absolute plus 1e-4 relative. At depth 50 the
    stem's gradient reaches ~6 and float32 itself is the limit: both
    packages land ~3e-4 from the port's float64 gradient there, and single
    entries of ~1 lie 2e-4 apart. So depth 50 holds each leaf within 5e-4
    of its largest entry, and the port's float32 gradients, all leaves
    together, no farther from float64 (root of the summed squares) than
    twice the JAX package's, plus 1e-6."""
    jm, spec, npp = _pair(depth, image, seed=3)
    x = _images(11, 3, image)
    y = np.asarray([0, 4, 2], np.float32)[:, None]   # index labels
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jnp.mean(jm.loss_vector(
        p, {"x": jnp.asarray(x), "y": jnp.asarray(y)}))))(
            jax.tree.map(jnp.asarray, npp))
    tl, tg = _port_grads(spec, npp, x, y, torch.float32)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    exact = _port_grads(spec, npp, x, y, torch.float64)[1] if depth == 50 \
        else None
    port_sq = jax_sq = 0.0
    for (ln, pn), g in tg.items():
        want = np.asarray(jg[ln][pn], np.float64)
        if exact is None:
            np.testing.assert_allclose(g, want, err_msg=f"{ln}/{pn}",
                                       **GRAD_TOL)
            continue
        ref = exact[(ln, pn)]
        np.testing.assert_allclose(g, want, rtol=0, err_msg=f"{ln}/{pn}",
                                   atol=5e-4 * np.abs(ref).max())
        port_sq += float(np.square(g - ref).sum())
        jax_sq += float(np.square(want - ref).sum())
    assert np.sqrt(port_sq) <= 2 * np.sqrt(jax_sq) + 1e-6


def test_same_padding_is_asymmetric():
    """The stride-2 convolutions pad after, not around: a 3x3/2 on 32
    pixels pads (0, 1) and the 7x7/2 stem on 224 (2, 3)."""
    from sparkflow_tpu_torch.graphdef import _same_pads
    assert _same_pads(32, 3, 2) == (0, 1)
    assert _same_pads(224, 7, 2) == (2, 3)
    assert _same_pads(112, 3, 2) == (0, 1)
    m = ResNet50(10, image_size=224, device="cpu")
    assert m.param_specs()["stem"]["kernel"][0] == (7, 7, 3, 64)
    assert m.depth == 50 and m.width == 64 and not m.SUPPORTS_INT8_SERVING


def test_he_normal_draw():
    """``init`` routes every initializer through ``graphdef.initialize``:
    a conv kernel is a normal truncated at two standard deviations whose
    standard deviation is sqrt(2 / fan_in), fan_in = kh * kw * cin."""
    m = model_from_json(build_registry_spec(
        "resnet", num_classes=10, depth=18, image_size=32, width=16),
        device="cpu")
    tree = m.init(torch.Generator().manual_seed(0))
    k = tree["stage1_block0"]["conv2"]                    # 3x3x32x32
    fan_in = 3 * 3 * 32
    std = float(k.std())
    assert abs(std - np.sqrt(2.0 / fan_in)) < 0.02 * np.sqrt(2.0 / fan_in)
    scaled = float(k.abs().max()) / np.sqrt(2.0 / fan_in)
    assert scaled <= 2.0 / 0.87962566103423978 + 1e-6   # truncated at 2 sd
    a = initialize("he_normal", (3, 3, 32, 32), torch.Generator().manual_seed(0))
    b = initialize("he_normal", (3, 3, 32, 32), torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert torch.equal(tree["head"]["kernel"], torch.zeros(128, 10))
    assert torch.equal(tree["stem"]["gn_scale"], torch.ones(16))


def test_weights_carry_both_ways():
    jm, spec, npp = _pair(50, 72, seed=4)
    tm = model_from_json(spec, device="cpu")
    tp = params_from_jax(tm, npp)
    flat = params_to_list(tm, tp)
    from sparkflow_tpu.graphdef import params_to_list as jax_to_list
    want = jax_to_list(jm, npp)
    assert len(flat) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(flat, want))
    again = list_to_params(tm, flat)
    assert all(torch.equal(again[ln][pn], tp[ln][pn])
               for ln in tp for pn in tp[ln])


def _cifar_df(localml, n=24, image=32, seed=0):
    """``examples/resnet_cifar.py``'s synthetic CIFAR rows at a small size:
    flattened NHWC vectors, labels 0-9."""
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        label = rs.randint(0, 10)
        img = rs.rand(image * image * 3) * (0.5 + 0.05 * label)
        rows.append((float(label), localml.Vectors.dense(img)))
    spark = localml.LocalSession.builder.appName("cifar").getOrCreate()
    return spark.createDataFrame(rows, ["label", "features"])


def test_estimator_fits_and_the_jax_package_transforms_the_same():
    """``examples/resnet_cifar.py``'s path on the port at depth 18, width
    4: fit, transform; the JAX package's ``SparkAsyncDLModel`` given the
    fitted stage's Params transforms its own DataFrame to the same
    probabilities."""
    import sparkflow_tpu.localml as jlocal
    import sparkflow_tpu_torch.localml as tlocal
    spec = build_registry_spec("resnet", num_classes=10, depth=18,
                               image_size=32, width=4)
    est = SparkAsyncDL(inputCol="features", tensorflowGraph=spec,
                       tfInput="x:0", tfLabel="y:0", tfOutput="probs:0",
                       tfOptimizer="adam", tfLearningRate=1e-3, iters=2,
                       miniBatchSize=8, labelCol="labels",
                       predictionCol="probs", device="cpu")
    fitted = Pipeline(stages=[
        OneHotEncoder(inputCol="label", outputCol="labels", dropLast=False),
        est]).fit(_cifar_df(tlocal))
    ours = fitted.stages[-1]
    got = np.array([np.asarray(r["probs"].toArray()) for r in
                    ours.transform(_cifar_df(tlocal)).collect()])
    assert got.shape == (24, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    keys = ("inputCol", "modelJson", "modelWeights", "tfInput", "tfOutput",
            "tfDropout", "toKeepDropout", "predictionCol")
    theirs = JaxModel(**{k: ours.getOrDefault(k) for k in keys})
    want = np.array([np.asarray(r["probs"].toArray()) for r in
                     theirs.transform(_cifar_df(jlocal)).collect()])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert isinstance(model_from_json(spec, device="cpu"), ResNet)
