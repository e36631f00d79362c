"""The port's image classifiers (analytics_zoo_tpu_torch/models/image/
imageclassification/) held against the JAX package's flax modules on
the CPU, from the same flax params and batch_stats (the port's weights
taken to the flax layout by `convert.image_to_flax`, and a JAX init
tree brought over by `convert.image_from_flax`):

* each backbone's f32 forward, in training mode (batch statistics, and
  the running statistics it leaves) and in eval mode (the running
  ones);
* two Adam steps through the port's `fit` against JAX's `from_flax`
  `fit`: epoch losses and batch_stats, also with a ragged
  last batch, whose zero padding rows enter BatchNorm's statistics on
  both sides (the padding mask reaches only the loss);
* flax's BatchNorm (momentum 0.99, the biased variance) and XLA's
  "SAME" padding, each pinned on its own;
* `ImageClassifier` save / load with its running statistics.

Tolerances: 1e-4 of the largest output for the forwards.  Flax's
training-mode BatchNorm computes the fast variance E[x^2] - E[x]^2 in
f32 and the port torch's fused kernel (Welford); where a channel's mean
is large against its spread, the cancellation magnifies the f32
rounding of the two; eval mode reads ~2e-5 against small outputs.
1e-5 absolute for the fits' losses and batch_stats, the f32 arithmetic
of two steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_chronos_cases import two_torch_threads  # noqa: F401
from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.models.image import imageclassification as jic
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.convert import image_from_flax, image_to_flax
from analytics_zoo_tpu_torch.models.image import imageclassification as ic
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    BatchNorm,
    Conv,
    max_pool,
    same_padding,
)
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.serving import InferenceModel

FWD_TOL, FIT_TOL = 1e-4, 1e-5
F32 = dict(dtype=jnp.float32)
PORT = dict(dtype=torch.float32, device="cpu")
#: (JAX module, port constructor) at test widths, dropout 0 (the port's
#: masks come from torch.Generator, not JAX's key)
BACKBONES = {
    "resnet_basic": (
        lambda: jic.ResNet(stage_sizes=(1, 1), num_classes=3, **F32),
        lambda: ic.ResNet(stage_sizes=(1, 1), num_classes=3, **PORT)),
    "resnet_bottleneck": (
        lambda: jic.ResNet(stage_sizes=(1, 1), block="bottleneck",
                           num_classes=3, **F32),
        lambda: ic.ResNet(stage_sizes=(1, 1), block="bottleneck",
                          num_classes=3, **PORT)),
    "inception": (
        lambda: jic.InceptionV1(num_classes=3, width=0.125, dropout=0.0,
                                **F32),
        lambda: ic.InceptionV1(num_classes=3, width=0.125, dropout=0.0,
                               **PORT)),
    "mobilenet": (
        lambda: jic.MobileNetV2(num_classes=3, width=0.125, dropout=0.0,
                                **F32),
        lambda: ic.MobileNetV2(num_classes=3, width=0.125, dropout=0.0,
                               **PORT)),
    "vgg": (
        lambda: jic.VGG16(num_classes=3, width=0.125, fc_dim=32, dropout=0.0,
                          **F32),
        lambda: ic.VGG16(num_classes=3, width=0.125, fc_dim=32, dropout=0.0,
                         image_size=32, **PORT)),
}


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context(cluster_mode="local")
    yield


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(
        np.float32)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _tree_close(got, want, tol):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=tol)


@pytest.mark.parametrize("name", list(BACKBONES))
def test_forward_matches_jax_in_train_and_eval_mode(name):
    make_jax, make_port = BACKBONES[name]
    jm = make_jax()
    torch.manual_seed(0)
    port = make_port()
    params, stats = image_to_flax(port.state_dict())
    x = _images(8)
    want, upd = jax.jit(lambda v, x: jm.apply(
        v, x, training=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x)).numpy()
    _close(got, want, FWD_TOL)
    # the running statistics the training forward leaves (relative: an
    # unnormalized conv output's variance may be large)
    for g, w in zip(jax.tree_util.tree_leaves(image_to_flax(
            port.state_dict())[1]), jax.tree_util.tree_leaves(
            upd["batch_stats"])):
        np.testing.assert_allclose(g, np.asarray(w), rtol=FIT_TOL,
                                   atol=FIT_TOL)
    want = jax.jit(lambda v, x: jm.apply(v, x))(
        {"params": params, **upd}, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    _close(got, want, FWD_TOL)


def test_converters_take_a_jax_init_tree():
    jm = jic.ResNet(stage_sizes=(1, 1), block="bottleneck", num_classes=3,
                    **F32)
    x = _images(4, seed=1)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    port = ic.ResNet(stage_sizes=(1, 1), block="bottleneck", num_classes=3,
                     **PORT).eval()
    port.load_state_dict(image_from_flax(variables["params"],
                                         variables["batch_stats"]))
    params, stats = image_to_flax(port.state_dict())
    _tree_close(params, variables["params"], 0.0)
    _tree_close(stats, variables["batch_stats"], 0.0)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, jax.jit(jm.apply)(variables, x), FWD_TOL)
    with pytest.raises(ValueError, match="unknown entry"):
        image_from_flax({"stem": {"kernel": np.zeros((1, 1, 3, 4)),
                                  "gamma": np.zeros(4)}})


@pytest.mark.parametrize("n,optimizer", [(32, "adam"), (37, "adam"),
                                         (37, "sgd")],
                         ids=["even", "ragged", "ragged-sgd"])
def test_fit_matches_the_jax_estimator(n, optimizer):
    jm = jic.ResNet(stage_sizes=(1, 1), block="bottleneck", num_classes=2,
                    **F32)
    torch.manual_seed(1)
    port = ic.ResNet(stage_sizes=(1, 1), block="bottleneck", num_classes=2,
                     **PORT)
    params, stats = image_to_flax(port.state_dict())
    x = _images(n, seed=2)
    y = (x[:, :16].mean(axis=(1, 2, 3)) > 0).astype(np.int32)
    jest = JaxEstimator.from_flax(jm, loss="sparse_categorical_crossentropy",
                                  optimizer=optimizer, learning_rate=1e-3)
    jest._params = jax.tree_util.tree_map(jnp.asarray, params)
    jest._model_state = {"batch_stats": jax.tree_util.tree_map(jnp.asarray,
                                                                stats)}
    jest.fit({"x": x, "y": y}, epochs=1, batch_size=16, shuffle=False)
    est = Estimator.from_torch(port, loss="sparse_categorical_crossentropy",
                               optimizer=optimizer, learning_rate=1e-3)
    est.fit({"x": x, "y": y}, epochs=1, batch_size=16, shuffle=False)
    np.testing.assert_allclose(est.train_summary[-1]["loss"],
                               jest.train_summary[-1]["loss"], rtol=0,
                               atol=FIT_TOL)
    got_params, got_stats = image_to_flax(port.state_dict())
    want_stats = jax.tree_util.tree_map(
        np.asarray, jest.get_model_state()["batch_stats"])
    _tree_close(got_stats, want_stats, FIT_TOL)
    # the parameters.  Adam's first steps move an element by about the
    # learning rate in its gradient's sign, and an f32 gradient through
    # training-mode BatchNorm at init is noisy to percents of its
    # largest element (the summation order, hence the thread count,
    # picks the noise), so a small gradient's sign is either side's:
    # within 2 steps x 1e-3.  SGD's step is the gradient times 1e-3:
    # within FIT_TOL
    want_params = jax.tree_util.tree_map(np.asarray, jest.get_model())
    _tree_close(got_params, want_params,
                2e-3 if optimizer == "adam" else FIT_TOL)
    # the fit moved the statistics (the padding rows of the ragged
    # batch included, as in JAX's)
    assert not np.allclose(got_stats["stem_bn"]["var"],
                           stats["stem_bn"]["var"])
    preds = est.predict({"x": x}, batch_size=16)
    with torch.no_grad():
        direct = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(preds, direct, rtol=0, atol=1e-6)


def test_batchnorm_keeps_flax_momentum_and_biased_variance():
    # rows 1, 3, 5, 7: mean 4, biased variance 5 (unbiased 6.67)
    bn = BatchNorm(1, device="cpu").train()
    x = torch.tensor([[1.0], [3.0], [5.0], [7.0]])
    y = bn(x)
    assert torch.allclose(bn.running_mean, torch.tensor([0.04]))
    assert torch.allclose(bn.running_var, torch.tensor([0.99 + 0.01 * 5.0]))
    assert torch.allclose(y[:, 0], (x[:, 0] - 4.0) / np.sqrt(5.0 + 1e-5))
    jbn = jax.tree_util.tree_map(np.asarray, __import__("flax").linen
                                 .BatchNorm(use_running_average=False,
                                            dtype=jnp.float32)
                                 .apply({"params": {"scale": np.ones(1),
                                                    "bias": np.zeros(1)},
                                         "batch_stats": {
                                             "mean": np.zeros(1),
                                             "var": np.ones(1)}},
                                        x.numpy(), mutable=["batch_stats"]))
    np.testing.assert_allclose(y.detach().numpy(), jbn[0], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               jbn[1]["batch_stats"]["var"], atol=1e-7)
    # torch's own BatchNorm keeps the unbiased variance
    tbn = torch.nn.BatchNorm1d(1, momentum=0.01).train()
    tbn(x)
    assert abs(float(tbn.running_var) - 1.04) > 1e-2
    # the backward is that of the batch statistics: x's gradient of
    # sum(y * w) matches autograd through the plain formula
    # (in f64; the module's own arithmetic is f32)
    xg = torch.randn(6, 3, 4, 4, requires_grad=True)
    bn3 = BatchNorm(3, device="cpu").train()
    w = torch.randn(6, 3, 4, 4)
    (bn3(xg) * w).sum().backward()
    xr = xg.detach().double().requires_grad_()
    mean = xr.mean((0, 2, 3), keepdim=True)
    var = (xr * xr).mean((0, 2, 3), keepdim=True) - mean ** 2
    (((xr - mean) / torch.sqrt(var + 1e-5)) * w.double()).sum().backward()
    torch.testing.assert_close(xg.grad, xr.grad.float(), rtol=0, atol=1e-5)


def test_same_padding_is_xla_s():
    # flax's 3x3/2 max_pool on a 4x4 ramp pads (0, 1): [[10, 11], [14, 15]]
    ramp = torch.arange(16.0).reshape(1, 1, 4, 4)
    got = max_pool(ramp, 3, 2, "SAME")
    assert got[0, 0].tolist() == [[10.0, 11.0], [14.0, 15.0]]
    assert torch.nn.functional.max_pool2d(ramp, 3, 2, 1)[0, 0].tolist() \
        == [[5.0, 7.0], [13.0, 15.0]]
    want = np.asarray(__import__("flax").linen.max_pool(
        ramp.numpy().transpose(0, 2, 3, 1), (3, 3), (2, 2), "SAME"))
    assert got[0, 0].numpy().tolist() == want[0, :, :, 0].tolist()
    assert same_padding(224, 7, 2) == (2, 3)
    assert same_padding(112, 3, 2) == (0, 1)
    assert same_padding(7, 3, 1) == (1, 1)
    # a strided conv against flax's on an even input
    conv = Conv(2, 3, 3, 2, dtype=torch.float32, device="cpu")
    x = _images(2, seed=3)[..., :2]
    kernel = conv.weight.detach().numpy().transpose(2, 3, 1, 0)
    want = __import__("flax").linen.Conv(3, (3, 3), 2, padding="SAME").apply(
        {"params": {"kernel": kernel, "bias": conv.bias.detach().numpy()}},
        x)
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_image_classifier_registry_and_save_load(tmp_path):
    for name in ("resnet-18", "resnet-50", "inception-v1", "mobilenet-v2",
                 "vgg-16"):
        assert name in ic.ImageClassifier.BACKBONES
        assert name in jic.ImageClassifier.BACKBONES
    with pytest.raises(ValueError, match="unknown backbone"):
        ic.ImageClassifier("resnet-101", device="cpu")
    torch.manual_seed(2)
    clf = ic.ImageClassifier("resnet-18", num_classes=3, **PORT)
    x = _images(4, seed=4)
    clf.train()
    with torch.no_grad():
        clf(torch.from_numpy(x))     # moves the running statistics
    path = clf.save_model(str(tmp_path / "clf"))
    back = ic.ImageClassifier.load_model(path, device="cpu")
    assert back.get_config() == clf.get_config()
    assert back.get_config()["model_name"] == "resnet-18"
    got, want = back.state_dict(), clf.state_dict()
    assert set(got) == set(want)
    assert any(k.endswith("running_var") for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    served = InferenceModel().load_model(path, device="cpu").predict(x)
    with torch.no_grad():
        direct = clf.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(served, direct)


def test_bf16_forward_matches_jax():
    jm = jic.ResNet(stage_sizes=(1, 1), num_classes=3)
    torch.manual_seed(3)
    port = ic.ResNet(stage_sizes=(1, 1), num_classes=3, device="cpu").eval()
    params, stats = image_to_flax(port.state_dict())
    x = _images(4, seed=5)
    want = jm.apply({"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    # bf16 convs on both sides, rounded in other places
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=0.05)
