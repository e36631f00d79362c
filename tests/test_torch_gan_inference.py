"""The port's GANEstimator (orca/learn/gan.py) and InferenceEstimator
(orca/learn/inference_estimator.py) held against the JAX package's on
the CPU.

GAN: one batch of the adversarial update with d_steps / g_steps of 1
and 2, the port's `_step` fed the noise JAX's `_step_fn` draws (its key
chain replayed: gan.py:68-69, 91-92, 104-105), from the same weights;
both modules' parameters after the batch within 1e-5 (f32 Adam steps of
1e-3 from the same gradients: the first step moves each weight by about
lr * sign(g), so the gradients' rounding differences stay far inside
it).  Also save / load, generate's shapes and a fit.

InferenceEstimator: predict within 1e-5 of JAX's on the same
TextClassifier weights and ragged batches, evaluate's accuracy equal,
and fit raising; from_saved_model on the port's save directory
predicting as the model itself does."""

import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn
import jax

from analytics_zoo_tpu.models.textclassification import (
    TextClassifier as JaxTextClassifier,
)
from analytics_zoo_tpu.orca.learn.gan import GANEstimator as JaxGAN
from analytics_zoo_tpu.orca.learn.inference_estimator import (
    InferenceEstimator as JaxInferenceEstimator,
)
from analytics_zoo_tpu.serving.inference_model import (
    InferenceModel as JaxInferenceModel,
)
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.models.textclassification import TextClassifier
from analytics_zoo_tpu_torch.orca.learn import (
    GANEstimator,
    InferenceEstimator,
)
from analytics_zoo_tpu_torch.orca.learn.gan import (
    default_discriminator_loss,
    default_generator_loss,
)
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel

TOL = 1e-5
NOISE, BATCH = 4, 16


class _JaxG(fnn.Module):
    @fnn.compact
    def __call__(self, z):
        h = fnn.relu(fnn.Dense(32)(z))
        return fnn.Dense(2)(h)


class _JaxD(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(fnn.Dense(32)(x))
        return fnn.Dense(1)(h)


class _Mlp(nn.Module):
    """flax's `Dense(32) -> relu -> Dense(out)`, flax's auto-names."""

    def __init__(self, fan_in, out):
        super().__init__()
        self.Dense_0 = nn.Linear(fan_in, 32)
        self.Dense_1 = nn.Linear(32, out)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _from_flax(module, tree):
    module.load_state_dict({
        f"{name}.{'weight' if leaf == 'kernel' else 'bias'}":
            torch.from_numpy(np.array(arr.T if leaf == "kernel" else arr))
        for name, node in tree.items() for leaf, arr in node.items()})
    return module


def _to_flax(module):
    tree = {}
    for k, v in module.state_dict().items():
        name, leaf = k.split(".")
        v = v.numpy()
        tree.setdefault(name, {})["kernel" if leaf == "weight" else
                                  "bias"] = v.T if leaf == "weight" else v
    return tree


def _real(n, seed=0):
    return np.random.default_rng(seed).normal(
        [3.0, -2.0], 0.3, (n, 2)).astype(np.float32)


@pytest.mark.parametrize("d_steps,g_steps", [(1, 1), (2, 1), (1, 2)])
def test_one_batch_matches_jax_on_its_noise(d_steps, g_steps):
    real = _real(BATCH)
    jg = JaxGAN(_JaxG(), _JaxD(), noise_dim=NOISE, d_steps=d_steps,
                g_steps=g_steps, seed=3)
    jg._init(real[:1])
    start = jax.tree_util.tree_map(np.array, {"g": jg._state["g"],
                                              "d": jg._state["d"]})
    # JAX's key chain: _init splits (r1, r2, rng); each sub-step splits
    # (rng, rz) and draws its noise from rz
    rng = jax.random.split(jax.random.PRNGKey(3), 3)[2]
    noise = []
    for _ in range(d_steps + g_steps):
        rng, rz = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(rz, (BATCH, NOISE)))))
    jg._state, stats = jg._step_fn(jg._state, real)
    gan = GANEstimator(_from_flax(_Mlp(NOISE, 2), start["g"]),
                       _from_flax(_Mlp(2, 1), start["d"]), noise_dim=NOISE,
                       d_steps=d_steps, g_steps=g_steps, seed=3)
    got = gan._step(torch.from_numpy(real), noise[:d_steps],
                    noise[d_steps:])
    for key in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(got[key]), float(stats[key]),
                                   atol=TOL)
    for side, module in (("g", gan.gen), ("d", gan.disc)):
        want = jax.tree_util.tree_leaves(jg._state[side])
        have = jax.tree_util.tree_leaves(_to_flax(module))
        for a, b in zip(have, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL)


def test_losses_match_jax():
    from analytics_zoo_tpu.orca.learn import gan as jax_gan
    rng = np.random.default_rng(1)
    r, f = rng.normal(0, 3, (2, 32)).astype(np.float32)
    np.testing.assert_allclose(
        float(default_discriminator_loss(torch.from_numpy(r),
                                         torch.from_numpy(f))),
        float(jax_gan.default_discriminator_loss(r, f)), atol=1e-6)
    np.testing.assert_allclose(
        float(default_generator_loss(torch.from_numpy(f))),
        float(jax_gan.default_generator_loss(f)), atol=1e-6)


def test_fit_generate_save_load(tmp_path):
    torch.manual_seed(0)
    gan = GANEstimator(_Mlp(NOISE, 2), _Mlp(2, 1), noise_dim=NOISE,
                       d_steps=2, g_steps=1)
    real = _real(72)
    gan.fit({"x": real}, epochs=3, batch_size=BATCH)
    assert len(gan.train_summary) == 3
    assert all(np.isfinite(list(s.values())).all()
               for s in gan.train_summary)
    assert gan.generate(7).shape == (7, 2)
    assert gan.discriminate(real[:5]).shape == (5,)
    np.testing.assert_array_equal(gan.generate(5, seed=2),
                                  gan.generate(5, seed=2))
    path = gan.save(str(tmp_path / "gan.pt"))
    other = GANEstimator(_Mlp(NOISE, 2), _Mlp(2, 1), noise_dim=NOISE)
    other.load(path)
    np.testing.assert_array_equal(other.generate(8, seed=3),
                                  gan.generate(8, seed=3))
    np.testing.assert_array_equal(other.discriminate(real[:4]),
                                  gan.discriminate(real[:4]))
    with pytest.raises(ValueError, match="full batch"):
        gan.fit({"x": real[:8]}, batch_size=BATCH)
    # a given optimizer, built from the module's parameters
    custom = GANEstimator(_Mlp(NOISE, 2), _Mlp(2, 1), noise_dim=NOISE,
                          generator_optimizer=lambda p: torch.optim.SGD(
                              p, lr=0.0))
    before = [p.clone() for p in custom.gen.parameters()]
    custom.fit(real, epochs=1, batch_size=BATCH)
    assert all(torch.equal(a, b)
               for a, b in zip(before, custom.gen.parameters()))


TC_KW = dict(class_num=3, vocab_size=40, embed_dim=8, sequence_length=10,
             encoder="gru", encoder_output_dim=12, dropout=0.0)


@pytest.fixture(scope="module")
def classifiers():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 40, (37, 10)).astype(np.int32)
    y = rng.integers(0, 3, 37).astype(np.int32)
    jm = JaxTextClassifier(**TC_KW)
    p = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(0),
                                                 ids[:1])["params"])
    m = TextClassifier(**TC_KW, device="cpu")
    m.load_state_dict(convert.text_classifier_from_flax(p))
    return ids, y, jm, p, m


def test_inference_estimator_matches_jax(classifiers):
    ids, y, jm, p, m = classifiers
    jest = JaxInferenceEstimator.from_model(
        JaxInferenceModel().load_flax(jm, p))
    est = InferenceEstimator.from_model(InferenceModel().load_module(m))
    want = jest.predict({"x": ids}, batch_size=16)
    got = est.predict({"x": ids}, batch_size=16)
    assert got.shape == (37, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert est.evaluate({"x": ids, "y": y}, batch_size=16) == \
        jest.evaluate({"x": ids, "y": y}, batch_size=16)
    with pytest.raises(NotImplementedError):
        est.fit({"x": ids, "y": y})
    with pytest.raises(ValueError, match="labels"):
        est.evaluate({"x": ids})


def test_from_saved_model_predicts_as_the_model(classifiers, tmp_path):
    ids, y, _, _, m = classifiers
    path = m.save_model(str(tmp_path / "tc"))
    est = InferenceEstimator.from_saved_model(path, device="cpu")
    assert type(est.model._module) is TextClassifier
    m.eval()
    with torch.no_grad():
        want = m(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(est.predict({"x": ids}, batch_size=16), want,
                               rtol=0, atol=1e-6)
    stats = est.evaluate({"x": ids, "y": y}, batch_size=16,
                         metrics=["accuracy"])
    own = m.estimator().evaluate({"x": ids, "y": y}, batch_size=16)
    assert stats["accuracy"] == pytest.approx(own["accuracy"], abs=1e-6)


@pytest.mark.parametrize("name", ["TextClassifier", "AnomalyDetector",
                                  "Seq2Seq", "KNRM", "VAE"])
def test_saved_zoo_models_load_by_class_name(name, tmp_path):
    """`InferenceModel.load_model` finds each new model by its saved class
    name and serves its weights."""
    from analytics_zoo_tpu_torch import models
    from analytics_zoo_tpu_torch.models.anomalydetection import (
        AnomalyDetector,
    )
    from analytics_zoo_tpu_torch.models.seq2seq import Seq2Seq
    from analytics_zoo_tpu_torch.models.textmatching import KNRM
    build = {"TextClassifier": lambda: TextClassifier(**TC_KW, device="cpu"),
             "AnomalyDetector": lambda: AnomalyDetector((4,), (0.0,),
                                                        device="cpu"),
             "Seq2Seq": lambda: Seq2Seq(hidden_size=4, input_dim=2,
                                        device="cpu"),
             "KNRM": lambda: KNRM(4, 6, vocab_size=30, embed_dim=8,
                                  kernel_num=5, device="cpu"),
             "VAE": lambda: models.VAE(image_shape=(8, 8, 1),
                                       enc_features=(2, 4), device="cpu")}
    model = build[name]()
    path = model.save_model(str(tmp_path / name))
    im = InferenceModel().load_model(path, device="cpu")
    assert type(im._module) is type(model)
    for (k, a), b in zip(model.state_dict().items(),
                         im._module.state_dict().values()):
        assert torch.equal(a, b), k
