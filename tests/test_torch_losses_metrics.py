"""The port's loss, metric and optimizer registries
(analytics_zoo_tpu_torch/orca/learn/{losses,metrics,optimizers}.py)
held against the JAX package's, name by name, on the same numpy inputs
from a seed, at f32.

Tolerances, each with its reason:
  * losses and metrics: per-example values within 1e-6 of the largest
    |value| of the batch (relative), the same f32 functions (clamps and
    epsilons included) evaluated by XLA and by PyTorch, whose
    transcendentals (log, exp, softplus, sigmoid) differ by an ulp or
    two; the 0/1 metrics exactly;
  * optimizers: parameters after each of 5 steps within 1e-6 relative
    to their largest magnitude, against optax through the JAX registry
    (`rsqrt` and `sqrt` an ulp apart, compounded over 5 steps); a step
    skipped on a non-finite gradient leaves parameters and state
    bitwise unchanged."""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from analytics_zoo_tpu.orca.learn import losses as jax_losses
from analytics_zoo_tpu.orca.learn import metrics as jax_metrics
from analytics_zoo_tpu.orca.learn import optimizers as jax_optimizers
from analytics_zoo_tpu_torch.orca.learn import losses, metrics, optimizers

REL = 1e-6
B, C = 12, 5


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _inputs(name, rng):
    """(preds, labels) fitting the loss: logits or probabilities
    against integer, one-hot, binary or real labels."""
    logits = (2.0 * rng.normal(size=(B, C))).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    binary = rng.integers(0, 2, (B, 3)).astype(np.float32)
    real = rng.normal(size=(B, 3)).astype(np.float32)
    positive = rng.uniform(0.1, 3.0, (B, 3)).astype(np.float32)
    if name == "sparse_categorical_crossentropy":
        return logits, rng.integers(0, C, B).astype(np.int32)
    if name in ("categorical_crossentropy", "kld",
                "kullback_leibler_divergence"):
        return (logits if name == "categorical_crossentropy" else probs,
                onehot)
    if name in ("binary_crossentropy", "hinge", "squared_hinge"):
        return real * 3, binary
    if name == "rank_hinge":
        return real[:, :1], binary[:, 0]
    if name in ("poisson",):
        return positive, binary * 2
    if name in ("mape", "mean_absolute_percentage_error"):
        return real, real + rng.normal(size=real.shape).astype(np.float32)
    if name in ("msle", "mean_squared_logarithmic_error"):
        return positive - 0.5, positive
    if name in ("logcosh", "log_cosh"):
        # large differences too: the stable form must stay finite
        return real * 50, real
    return real, rng.normal(size=real.shape).astype(np.float32)


def test_loss_registry_holds_the_jax_names():
    assert sorted(losses._REGISTRY) == sorted(jax_losses._REGISTRY)
    for name in jax_losses._REGISTRY:
        assert losses._REGISTRY[name].__name__ == \
            jax_losses._REGISTRY[name].__name__


@pytest.mark.parametrize("name", sorted(jax_losses._REGISTRY))
def test_loss_matches_jax(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    p, y = _inputs(name, rng)
    want = jax_losses.resolve(name)(jnp.asarray(p), jnp.asarray(y))
    got = losses.resolve(name)(torch.from_numpy(p), torch.from_numpy(y))
    assert got.shape == want.shape == (B,)
    assert bool(torch.isfinite(got).all())
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["sparse_categorical_crossentropy",
                                  "categorical_crossentropy",
                                  "binary_crossentropy"])
def test_loss_on_probabilities_matches_jax(name):
    """from_logits=False: the clamped log of probabilities, 0 and 1
    among them."""
    rng = np.random.default_rng(3)
    p = rng.uniform(0, 1, (B, C)).astype(np.float32)
    p[0, 0], p[1, 1] = 0.0, 1.0
    if name == "binary_crossentropy":
        y = rng.integers(0, 2, (B, C)).astype(np.float32)
    elif name == "categorical_crossentropy":
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    else:
        y = rng.integers(0, C, B).astype(np.int32)
    want = getattr(jax_losses, name)(jnp.asarray(p), jnp.asarray(y),
                                     from_logits=False)
    got = getattr(losses, name)(torch.from_numpy(p), torch.from_numpy(y),
                                from_logits=False)
    _close(got.numpy(), want)


@pytest.mark.parametrize("labels", ["01", "pm1"])
@pytest.mark.parametrize("name", ["hinge", "squared_hinge"])
def test_hinge_label_conventions_match_jax(name, labels):
    rng = np.random.default_rng(4)
    p = rng.normal(size=(B, 2)).astype(np.float32)
    y = rng.integers(0, 2, (B, 2)).astype(np.float32)
    if labels == "pm1":
        y = 2 * y - 1
    want = getattr(jax_losses, name)(jnp.asarray(p), jnp.asarray(y))
    _close(getattr(losses, name)(torch.from_numpy(p),
                                 torch.from_numpy(y)).numpy(), want)


def test_rank_hinge_masks_a_padded_tail_as_jax_does():
    """A batch of 12 whose last 3 rows are padding: the pair (9, 10)
    has a padded member and contributes 0 on both sides."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(B, 1)).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0
    want = jax_losses.rank_hinge(jnp.asarray(p), None,
                                 mask=jnp.asarray(mask))
    got = losses.rank_hinge(torch.from_numpy(p), None,
                            mask=torch.from_numpy(mask))
    _close(got.numpy(), want)
    assert float(got[9:].abs().max()) == 0.0 and float(got[:9].max()) > 0
    # the engine passes the mask to the losses that declare it
    from analytics_zoo_tpu_torch.orca.learn.spmd import _declares
    assert [n for n, f in losses._REGISTRY.items()
            if _declares(f, "mask")] == ["rank_hinge"]
    with pytest.raises(ValueError, match="even batch"):
        losses.rank_hinge(torch.zeros(3, 1), None)


def test_log_cosh_stays_finite_where_cosh_overflows():
    d = np.array([[-200.0, -50.0, 0.0, 1e-3, 50.0, 200.0]], np.float32)
    got = losses.log_cosh(torch.from_numpy(d), torch.zeros(1, 6))
    want = jax_losses.log_cosh(jnp.asarray(d), jnp.zeros((1, 6)))
    assert np.isfinite(got.numpy()).all()
    _close(got.numpy(), want)


def test_metric_registry_holds_the_jax_names():
    assert sorted(metrics._REGISTRY) == sorted(jax_metrics._REGISTRY)


def _metric_inputs(name, rng):
    logits = rng.normal(size=(B, C)).astype(np.float32)
    logits[0, :] = 0.5                     # ties
    if name in ("mae", "mse"):
        return (rng.normal(size=(B, 3)).astype(np.float32),
                rng.normal(size=(B, 3)).astype(np.float32))
    if name == "binary_accuracy":
        return (rng.normal(size=(B, 3)).astype(np.float32),
                rng.integers(0, 2, (B, 3)).astype(np.float32))
    if name == "categorical_accuracy":
        return logits, np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    return logits, rng.integers(0, C, B).astype(np.int32)


METRIC_NAMES = sorted(jax_metrics._REGISTRY) + [
    "top1accuracy", "top3_accuracy", "top10_accuracy", "TOP2Accuracy"]


@pytest.mark.parametrize("name", METRIC_NAMES)
def test_metric_matches_jax(name):
    rng = np.random.default_rng(len(name))
    p, y = _metric_inputs(name, rng)
    jm, m = jax_metrics.resolve(name), metrics.resolve(name)
    assert type(m).__name__ == type(jm).__name__
    assert m.get_name() == jm.get_name()
    want = np.asarray(jm(jnp.asarray(p), jnp.asarray(y)))
    got = m(torch.from_numpy(p), torch.from_numpy(y)).numpy()
    if name in ("mae", "mse"):
        _close(got, want)
    else:
        np.testing.assert_array_equal(got, want)


def test_binary_accuracy_and_top_k_options_match_jax():
    rng = np.random.default_rng(9)
    p = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    y = rng.integers(0, 2, (B, 2)).astype(np.float32)
    for kw in (dict(threshold=0.3, from_logits=False), dict(threshold=0.7)):
        np.testing.assert_array_equal(
            metrics.BinaryAccuracy(**kw)(torch.from_numpy(p),
                                         torch.from_numpy(y)).numpy(),
            np.asarray(jax_metrics.BinaryAccuracy(**kw)(jnp.asarray(p),
                                                        jnp.asarray(y))))
    logits = rng.normal(size=(B, C)).astype(np.float32)
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    np.testing.assert_array_equal(
        metrics.TopKCategoricalAccuracy(2)(torch.from_numpy(logits),
                                           torch.from_numpy(onehot)).numpy(),
        np.asarray(jax_metrics.TopKCategoricalAccuracy(2)(
            jnp.asarray(logits), jnp.asarray(onehot))))
    with pytest.raises(ValueError, match="k >= 1"):
        metrics.resolve("top0accuracy")


def test_optimizer_registry_holds_the_jax_names():
    assert sorted(optimizers._REGISTRY) == sorted(jax_optimizers._REGISTRY)


_SHAPES = {"w": (4, 3), "b": (3,)}


def _grads(rng, steps):
    out = [{k: (rng.normal(size=s) * 0.5).astype(np.float32)
            for k, s in _SHAPES.items()} for _ in range(steps)]
    out[1]["b"][0] = 0.0                  # a zero gradient element
    return out


def _optax_path(tx, params, grads):
    """Parameters after each step of `tx` from `params`."""
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state, path = tx.init(p), []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, p)
        p = optax.apply_updates(p, upd)
        path.append({k: np.asarray(v) for k, v in p.items()})
    return path


def _port_path(opt, params, grads, skip_at=None):
    """Parameters after each taken step of the port's optimizer; at
    `skip_at` a step with a non-finite gradient and `found_inf` set must
    leave parameters and state bitwise unchanged."""
    ps = {k: torch.tensor(v) for k, v in params.items()}
    torch_opt, sched = opt.build(ps.values())
    path = []
    for j, g in enumerate(grads):
        if j == skip_at:
            before = ({k: v.clone() for k, v in ps.items()},
                      {id(p): {k: t.clone() for k, t in s.items()}
                       for p, s in torch_opt.state.items()})
            for k, p in ps.items():
                p.grad = torch.full_like(p, float("nan"))
            torch_opt.found_inf = torch.ones(())
            torch_opt.step()
            for k, p in ps.items():
                assert torch.equal(p, before[0][k])
            for p, s in torch_opt.state.items():
                for k, t in s.items():
                    assert torch.equal(t, before[1][id(p)][k])
        for k, p in ps.items():
            p.grad = torch.tensor(g[k])
        torch_opt.found_inf = torch.zeros(())
        if sched is not None:
            sched.before_step()
        torch_opt.step()
        if sched is not None:
            sched.after_step(torch.ones(()))
        path.append({k: v.detach().numpy().copy() for k, v in ps.items()})
    return path


@pytest.mark.parametrize("name,lr", [("rmsprop", 1e-2), ("adagrad", 0.1),
                                     ("adadelta", 1.0), ("rmsprop", None),
                                     ("adagrad", None), ("adadelta", None)])
def test_new_optimizers_follow_optax(name, lr):
    """5 steps from the same parameters and gradients (at each
    registry's default rate and at a set one), a non-finite step skipped
    in the middle of the port's run."""
    rng = np.random.default_rng(11)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in _SHAPES.items()}
    grads = _grads(rng, 5)
    want = _optax_path(jax_optimizers.resolve(name, lr), params, grads)
    got = _port_path(optimizers.resolve(name, lr), params, grads, skip_at=2)
    moved = 0.0
    for g, w in zip(got, want):
        for k in _SHAPES:
            _close(g[k], w[k])
            moved = max(moved, float(np.abs(w[k] - params[k]).max()))
    assert moved > 1e-3


@pytest.mark.parametrize("name", ["rmsprop", "adagrad", "adadelta"])
def test_new_optimizers_take_a_schedule_as_optax_does(name):
    """With `learningrate_schedule` the rate is the schedule's device
    tensor; optax's alias given the same schedule function."""
    rng = np.random.default_rng(12)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in _SHAPES.items()}
    grads = _grads(rng, 5)
    sched = optimizers.Warmup(2, 5)
    port = getattr(optimizers, {"rmsprop": "RMSprop", "adagrad": "Adagrad",
                                "adadelta": "Adadelta"}[name])(
        0.1, learningrate_schedule=sched)
    fn = jax_optimizers.Warmup(2, 5).build(0.1)
    tx = {"rmsprop": lambda: optax.rmsprop(fn, decay=0.9, eps=1e-8),
          "adagrad": lambda: optax.adagrad(fn),
          "adadelta": lambda: optax.adadelta(fn, rho=0.95, eps=1e-6)}[name]()
    got = _port_path(port, params, grads)
    want = _optax_path(tx, params, grads)
    # the first step's rate is 0: nothing moves
    for k in _SHAPES:
        np.testing.assert_array_equal(got[0][k], params[k])
    for g, w in zip(got, want):
        for k in _SHAPES:
            _close(g[k], w[k])


def test_new_optimizers_differ_from_torch_optim():
    """The trap the port avoids: torch.optim's RMSprop and Adagrad
    compute other functions than optax's."""
    rng = np.random.default_rng(13)
    params = {"w": rng.normal(size=(6,)).astype(np.float32)}
    g = {"w": (1e-4 * rng.normal(size=(6,))).astype(np.float32)}
    for name, cls in (("rmsprop", torch.optim.RMSprop),
                      ("adagrad", torch.optim.Adagrad)):
        want = _optax_path(jax_optimizers.resolve(name, 0.01), params, [g])
        p = torch.tensor(params["w"], requires_grad=True)
        opt = cls([p], lr=0.01)
        p.grad = torch.tensor(g["w"])
        opt.step()
        assert np.abs(p.detach().numpy() - want[0]["w"]).max() > 1e-4
