"""The port's training slice, `Estimator.from_torch(module).fit(...)`
(analytics_zoo_tpu_torch/orca/learn/), held against the JAX
`Estimator.from_flax` on the same converted weights and the same numpy
data: a small BERT classifier (2 blocks, hidden 64, 2 heads of 32,
intermediate 128, t = 128, vocab 1000, flash attention, dropout off),
three Adam steps of one batch each.  The JAX side's flash attention runs
its Pallas kernels in interpret mode, forward and backward.

Then each optimizer the port resolves (AdamW, SGD with momentum,
Nesterov and weight decay, clipping by global norm and by value, one
bound or a (min, max) pair) against the JAX Estimator's optax chain on
a small MLP, and the clipping alone against optax's.

Also on the port alone: a ragged last batch counted exactly through the
padding mask, a non-finite step skipped with the parameters untouched,
and dropout drawn from the Estimator's seeded generator.

Tolerances, each with its reason:
  * f32 (compute_dtype f32 on both sides): losses 1e-5 absolute and
    final parameters 1e-5 absolute, the same f32 arithmetic summed in
    other orders, through 3 Adam steps of learning rate 1e-3 (and
    through 6 steps of each optimizer on the MLP);
  * bf16 (the JAX default, compute_dtype bf16 on both sides): losses
    0.05 absolute, `test_torch_bert.py`'s logits gate (both sides round
    the dense outputs and attention operands to bf16, at other places);
  * dropout: the kept share of n draws at rate 0.1 lies within 5
    binomial standard deviations of 0.9 (a false alarm about once in
    3.5 million runs)."""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.keras.layers.self_attention import (
    TransformerEncoder as JaxEncoder,
)
from analytics_zoo_tpu.models.bert import BERTClassifier as JaxClassifier
from analytics_zoo_tpu.orca.learn import losses as jax_losses
from analytics_zoo_tpu.orca.learn import metrics as jax_metrics
from analytics_zoo_tpu.orca.learn import optimizers as jax_optimizers
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.convert import (
    bert_from_flax,
    bert_to_flax,
    init_bert_params,
)
from analytics_zoo_tpu_torch.keras.layers.self_attention import dropout
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.ops.attention import dot_product_attention
from analytics_zoo_tpu_torch.orca.learn import Estimator, NaNLossError
from analytics_zoo_tpu_torch.orca.learn import losses, metrics, optimizers

CFG = dict(vocab=1000, hidden_size=64, n_head=2, n_block=2,
           intermediate_size=128, max_position_len=128)
N, T, LR, STEPS = 8, 128, 1e-3, 3
F32_TOL, BF16_TOL = 1e-5, 0.05


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache():
    """The JAX reference fits compile without `.jax_cache_tests`.  In a
    contended full run the BERT fit's `jit_scan` and `_train_step_impl`
    compiles pass the 5 s persistence floor; a later run that loads both
    back deadlocks in XLA:CPU's 8-device all-reduce (7 of 8 participants
    arrive, then the 40 s rendezvous timeout aborts the process), while
    fresh compiles of the same programs run clean.  As in
    `test_pipeline_parallel.py`, `reset_cache()` drops the memo of
    `is_cache_used` so the setting takes effect, on the way in and out."""
    from jax._src import compilation_cache

    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_compilation_cache_dir", prev)
    compilation_cache.reset_cache()


class _JaxF32Classifier(fnn.Module):
    """The JAX `BERTClassifier` with compute_dtype f32 and dropout off:
    the same tree ("bert", "classifier"), so `bert_from_flax` reads it."""

    @fnn.compact
    def __call__(self, ids, seg, mask, training: bool = False):
        _, pooled = JaxEncoder(**CFG, n_segments=2, with_pooler=True,
                               attn_impl="flash", compute_dtype=jnp.float32,
                               embedding_dropout=0.0, attn_dropout=0.0,
                               residual_dropout=0.0, name="bert")(
            ids, seg, None, mask, training)
        return fnn.Dense(2, name="classifier")(pooled)


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab"], (n, T)).astype(np.int32)
    seg = (np.arange(T)[None] >= T // 2).astype(np.int32).repeat(n, 0)
    lens = rng.integers(T // 4, T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    y = (ids[:, 0] < CFG["vocab"] // 2).astype(np.int32)
    return {"x": [ids, seg, mask], "y": y}


def _fit_both(jax_module, compute_dtype):
    tree = init_bert_params(dict(CFG, num_classes=2), seed=3)
    data = _data()
    init_orca_context(cluster_mode="local")
    jest = JaxEstimator.from_flax(
        jax_module, loss="sparse_categorical_crossentropy",
        optimizer="adam", learning_rate=LR, metrics=["accuracy"])
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, tree))
    jest.fit(data, epochs=STEPS, batch_size=N, shuffle=False)
    model = BERTClassifier(**CFG, num_classes=2, hidden_drop=0.0,
                           attn_drop=0.0, attn_impl="flash",
                           compute_dtype=compute_dtype, device="cpu")
    model.load_state_dict(bert_from_flax(tree, dict(CFG, num_classes=2)))
    est = Estimator.from_torch(model, loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=LR,
                               metrics=["accuracy"])
    est.fit(data, epochs=STEPS, batch_size=N, shuffle=False)
    return jest, est


def test_fit_f32_matches_the_jax_estimator():
    jest, est = _fit_both(_JaxF32Classifier(), torch.float32)
    want = [s["loss"] for s in jest.train_summary]
    got = [s["loss"] for s in est.train_summary]
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    # the loss moved: the comparison is of three different steps
    assert max(got) - min(got) > 1e-3
    assert [s["accuracy"] for s in est.train_summary] == \
        [s["accuracy"] for s in jest.train_summary]
    jparams = jax.device_get(jest.get_model())
    ours = bert_to_flax(est.get_model().state_dict(),
                        dict(CFG, num_classes=2))
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_o = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(flat_j) == len(flat_o)
    hid = CFG["hidden_size"]
    for path, want_leaf in flat_j:
        name = jax.tree_util.keystr(path)
        got_leaf, want_leaf = flat_o[path], np.asarray(want_leaf)
        if name.endswith("['qkv']['bias']"):
            # the key bias adds q.b_k to every score of a row, which the
            # softmax cancels: its gradient is 0 up to rounding on both
            # sides, and Adam turns that rounding into steps of up to
            # the learning rate, so it is held to STEPS * LR only
            np.testing.assert_array_less(
                np.abs(got_leaf - want_leaf)[..., hid:2 * hid],
                STEPS * LR)
            keep = np.r_[0:hid, 2 * hid:3 * hid]
            got_leaf, want_leaf = got_leaf[..., keep], want_leaf[..., keep]
        np.testing.assert_allclose(got_leaf, want_leaf, atol=F32_TOL, rtol=0,
                                   err_msg=name)


def test_fit_bf16_matches_the_jax_estimator():
    jest, est = _fit_both(JaxClassifier(**CFG, num_classes=2, hidden_drop=0.0,
                                        attn_drop=0.0, attn_impl="flash"),
                          torch.bfloat16)
    np.testing.assert_allclose([s["loss"] for s in est.train_summary],
                               [s["loss"] for s in jest.train_summary],
                               atol=BF16_TOL, rtol=0)


# ------------------------------------------------- the port's engine alone

class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.fc = torch.nn.Linear(4, 3)

    def forward(self, x):
        return self.fc(x)


def _linear_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return x, (x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0)


def test_ragged_last_batch_counts_every_example_once():
    """n = 101 at batch 33: the last batch holds 2 real rows and 31
    padding rows, which the mask keeps out of every mean."""
    x, y = _linear_data(101)
    est = Estimator.from_torch(_Linear(), loss="sparse_categorical_crossentropy",
                               metrics=["accuracy"])
    model = est.get_model()
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
    per_row = losses.sparse_categorical_crossentropy(logits,
                                                     torch.from_numpy(y))
    want_acc = float(metrics.Accuracy()(logits, torch.from_numpy(y)).mean())
    ev = est.evaluate((x, y), batch_size=33)
    assert ev["loss"] == pytest.approx(float(per_row.mean()), abs=1e-6)
    assert ev["accuracy"] == pytest.approx(want_acc, abs=1e-6)
    assert est.predict(x, batch_size=33).shape == (101, 3)
    # a fit over the same batches: four steps, the first on rows 0-32 of
    # the untrained model, and the epoch's loss their mean weighted by
    # the real rows of each (33, 33, 33, 2)
    est.fit((x, y), epochs=1, batch_size=33, shuffle=False)
    step_losses = [s["loss"] for s in est.engine.last_steps]
    assert est.engine.host_step == 4 and len(step_losses) == 4
    assert step_losses[0] == pytest.approx(float(per_row[:33].mean()),
                                           abs=1e-6)
    weighted = np.dot(step_losses, [33, 33, 33, 2]) / 101
    assert est.train_summary[-1]["loss"] == pytest.approx(weighted, abs=1e-6)


def test_non_finite_step_is_skipped_and_counted():
    x, y = _linear_data(16)
    bad = x.copy()
    bad[8:] = np.nan                       # the second batch of 8
    ref = Estimator.from_torch(_Linear(), loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=0.1)
    ref.fit((x[:8], y[:8]), batch_size=8, shuffle=False)
    est = Estimator.from_torch(_Linear(), loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=0.1)
    est.fit((bad, y), batch_size=8, shuffle=False)
    summary = est.train_summary[-1]
    assert summary["nan_steps"] == 1.0
    # the loss counts the good batch's 8 rows only
    assert summary["loss"] == pytest.approx(ref.train_summary[-1]["loss"])
    for a, b in zip(est.get_model().parameters(),
                    ref.get_model().parameters()):
        assert torch.equal(a, b)
    with pytest.raises(NaNLossError, match="1 training step"):
        est.fit((bad[8:], y[8:]), batch_size=8, nan_policy="raise")


@pytest.mark.parametrize("opt", ["sgd-momentum", "adamw"])
def test_non_finite_first_step_leaves_the_optimizer_fresh(opt):
    """A skipped first step leaves the optimizer's state as if it had
    not run (optax's zero momentum trace, Adam's step count 0), so the
    good step after it moves the parameters exactly as a fresh first
    step does."""
    x, y = _linear_data(16)
    bad = x.copy()
    bad[:8] = np.inf                       # the first batch of 8

    def fit(xs, ys):
        make = (optimizers.SGD(0.1, momentum=0.9, nesterov=True)
                if opt == "sgd-momentum" else "adamw")
        est = Estimator.from_torch(
            _Linear(), loss="sparse_categorical_crossentropy",
            optimizer=make, learning_rate=0.1 if opt == "adamw" else None)
        est.fit((xs, ys), batch_size=8, shuffle=False)
        return est

    est, ref = fit(bad, y), fit(x[8:], y[8:])
    assert est.train_summary[-1]["nan_steps"] == 1.0
    assert [s["_nan_steps"] for s in est.engine.last_steps] == [1.0, 0.0]
    for a, b in zip(est.get_model().parameters(),
                    ref.get_model().parameters()):
        assert torch.equal(a, b)


class _JaxDense2(fnn.Module):
    @fnn.compact
    def __call__(self, x, training: bool = False):
        return fnn.Dense(2, name="fc")(x)


@pytest.mark.parametrize("clip_norm", [None, 1.0], ids=["no-clip", "clip"])
def test_finite_gradients_whose_norm_overflows_take_the_step(clip_norm):
    """A gradient with only finite elements whose f32 global norm
    overflows (elements of 1.5e19: squares past the f32 range) is a
    finite step, as JAX tests each element (spmd.py's all(isfinite(g))):
    the step runs, and with clip_norm optax scales by clip_norm / inf = 0.
    Zero weights, x = 3e19, label 0, SGD at 1e-30: loss log 2, the kernel
    moves by 1.5e-11 unclipped.  Losses, nan_steps and the final params
    against the JAX Estimator at f32 1e-6 (relative for the params)."""
    x = np.full((4, 1), 3e19, np.float32)
    y = np.zeros(4, np.int32)
    zeros = {"fc": {"kernel": np.zeros((1, 2), np.float32),
                    "bias": np.zeros(2, np.float32)}}
    init_orca_context(cluster_mode="local")
    jest = JaxEstimator.from_flax(
        _JaxDense2(), loss="sparse_categorical_crossentropy",
        optimizer="sgd", learning_rate=1e-30, clip_norm=clip_norm)
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, zeros))
    jest.fit({"x": x, "y": y}, epochs=1, batch_size=4, shuffle=False)
    model = torch.nn.Linear(1, 2)
    with torch.no_grad():
        model.weight.zero_()
        model.bias.zero_()
    est = Estimator.from_torch(model, loss="sparse_categorical_crossentropy",
                               optimizer="sgd", learning_rate=1e-30,
                               clip_norm=clip_norm)
    est.fit({"x": x, "y": y}, epochs=1, batch_size=4, shuffle=False)
    got, want = est.train_summary[-1], jest.train_summary[-1]
    assert got.get("nan_steps", 0.0) == want.get("nan_steps", 0.0) == 0.0
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["loss"], np.log(2.0), rtol=1e-6)
    jw = jax.device_get(jest.get_model())["fc"]
    np.testing.assert_allclose(model.weight.detach().numpy().T,
                               np.asarray(jw["kernel"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(model.bias.detach().numpy(),
                               np.asarray(jw["bias"]), rtol=1e-6, atol=0)
    moved = float(np.abs(np.asarray(jw["kernel"])).max())
    assert moved == (0.0 if clip_norm else pytest.approx(1.5e-11))


def test_dropout_is_seeded_and_keeps_nine_tenths():
    cfg = dict(CFG, vocab=50, max_position_len=32)
    data = {"x": [a[:, :32] % 50 for a in _data(16)["x"]],
            "y": _data(16)["y"]}

    def fit(seed):
        model = BERTClassifier(**cfg, attn_impl="flash", device="cpu")
        model.load_state_dict(bert_from_flax(init_bert_params(
            dict(cfg, num_classes=2), seed=1), dict(cfg, num_classes=2)))
        est = Estimator.from_torch(model, learning_rate=1e-3, seed=seed)
        est.fit(data, epochs=1, batch_size=4, shuffle=True)
        return [s["loss"] for s in est.engine.last_steps]

    assert fit(5) == fit(5)
    assert fit(5) != fit(6)
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    kept = float((dropout(torch.ones(n), 0.1, True, gen) != 0).float().mean())
    assert abs(kept - 0.9) <= 5 * np.sqrt(0.9 * 0.1 / n)


def test_einsum_attention_dropout_keeps_nine_tenths():
    """v is the identity over keys, so the output is the dropped
    probabilities themselves: a tenth of them are zero."""
    b, t, h = 4, 64, 2
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(b, t, h, t, generator=gen)
    v = torch.eye(t)[None, :, None, :].expand(b, t, h, t)
    out = dot_product_attention(q, q, v, dropout_rate=0.1, generator=gen)
    kept = float((out != 0).float().mean())
    n = out.numel()
    assert abs(kept - 0.9) <= 5 * np.sqrt(0.9 * 0.1 / n)
    plain = dot_product_attention(q, q, v)
    # kept probabilities are scaled by 1 / 0.9
    np.testing.assert_allclose(out[out != 0].numpy(),
                               (plain[out != 0] / 0.9).numpy(), rtol=1e-5)


def test_registries_raise_on_unported_names():
    """The port's loss, metric and optimizer registries hold exactly the
    JAX registries' names, so the only names left to raise are those
    JAX does not know either: a ValueError, as JAX raises."""
    assert sorted(losses._REGISTRY) == sorted(jax_losses._REGISTRY)
    assert sorted(metrics._REGISTRY) == sorted(jax_metrics._REGISTRY)
    assert sorted(optimizers._REGISTRY) == sorted(jax_optimizers._REGISTRY)
    for mod in (losses, metrics, optimizers):
        assert not hasattr(mod, "_NOT_PORTED")
    with pytest.raises(ValueError, match="unknown loss"):
        losses.resolve("nope")
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.resolve("nope")
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.resolve("lbfgs")


@pytest.mark.parametrize("method", ["fit", "evaluate", "predict"])
def test_estimator_signatures_match_jax(method):
    """The JAX parameter names in the JAX order, so a positional call
    such as fit(df, 5, 256, ["user", "item"], ["label"]) means the same
    on both sides."""
    import inspect
    got = list(inspect.signature(getattr(Estimator, method)).parameters)
    want = list(inspect.signature(getattr(JaxEstimator, method)).parameters)
    assert got == want


def test_clip_norm_matches_optax():
    """The port's clipping against optax's on the same gradients, above
    and below the bound, then the elementwise bounds; the JAX `resolve`
    chains the clips before the optimizer, so its first update under
    SGD(1) with no momentum is minus the clipped gradient."""
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 2), (5,))]
    norm = np.sqrt(sum((g ** 2).sum() for g in grads))
    for bound in (0.5 * norm, 2.0 * norm):
        want, _ = optax.clip_by_global_norm(bound).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        got = [torch.from_numpy(g.copy()) for g in grads]
        optimizers.resolve("sgd", clip_norm=bound).clip_(
            got, torch.tensor(norm, dtype=torch.float32))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    for clip in (0.3, (-0.2, 0.7)):
        tx = jax_optimizers.resolve("sgd", 1.0, clip_value=clip)
        jg = [jnp.asarray(g) for g in grads]
        want, _ = tx.update(jg, tx.init(jg), jg)
        got = [torch.from_numpy(g.copy()) for g in grads]
        optimizers.resolve("sgd", 1.0, clip_value=clip).clip_(
            got, torch.tensor(norm))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), -np.asarray(w))


# ----------------------------------------- optimizers against the JAX ones

class _JaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x, training: bool = False):
        return fnn.Dense(3, name="fc2")(jnp.tanh(fnn.Dense(8, name="fc1")(x)))


class _MLP(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.fc1, self.fc2 = torch.nn.Linear(4, 8), torch.nn.Linear(8, 3)
        with torch.no_grad():
            for name in ("fc1", "fc2"):
                layer = getattr(self, name)
                layer.weight.copy_(torch.from_numpy(tree[name]["kernel"].T))
                layer.bias.copy_(torch.from_numpy(tree[name]["bias"]))

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))

    def tree(self):
        return {n: {"kernel": getattr(self, n).weight.detach().numpy().T,
                    "bias": getattr(self, n).bias.detach().numpy()}
                for n in ("fc1", "fc2")}


def _mlp_tree(seed=2):
    rng = np.random.default_rng(seed)
    return {n: {"kernel": rng.normal(size=s).astype(np.float32),
                "bias": (0.1 * rng.normal(size=s[1])).astype(np.float32)}
            for n, s in (("fc1", (4, 8)), ("fc2", (8, 3)))}


# (port optimizer, JAX optimizer, learning_rate, clip_norm, clip_value);
# the clip bounds are below this data's gradients, so every clip acts
_OPT_CASES = {
    "adamw": ("adamw", "adamw", 1e-2, None, None),
    "sgd": ("sgd", "sgd", 0.1, None, None),
    "sgd-momentum": (optimizers.SGD(0.1, momentum=0.9),
                     jax_optimizers.SGD(0.1, momentum=0.9), None, None, None),
    "sgd-nesterov-decay": (
        optimizers.SGD(0.1, momentum=0.9, nesterov=True, weight_decay=0.05),
        jax_optimizers.SGD(0.1, momentum=0.9, nesterov=True,
                           weight_decay=0.05), None, None, None),
    "adam-clip-norm": ("adam", "adam", 1e-2, 0.05, None),
    "sgd-clip-value": ("sgd", "sgd", 0.5, None, 0.02),
    "sgd-clip-value-pair": ("sgd", "sgd", 0.5, None, (-0.01, 0.03)),
    "adamw-clip-norm-and-value": ("adamw", "adamw", 1e-2, 0.05, 0.01),
    "rmsprop": ("rmsprop", "rmsprop", 1e-2, None, None),
    "adagrad-clip-norm": ("adagrad", "adagrad", 0.1, 0.05, None),
    "adadelta-clip-value": ("adadelta", "adadelta", None, None, 0.01),
}


@pytest.mark.parametrize("case", list(_OPT_CASES))
def test_optimizer_fit_matches_the_jax_estimator(case):
    """Two epochs of three steps on a small MLP from the same weights:
    per-epoch losses and final parameters at f32 1e-5 (the same f32
    arithmetic in other orders).  A clipped case must also land
    elsewhere than the same fit without clipping."""
    opt, jopt, lr, clip_norm, clip_value = _OPT_CASES[case]
    tree = _mlp_tree()
    x, y = _linear_data(24)
    data = {"x": x, "y": y}
    init_orca_context(cluster_mode="local")
    jest = JaxEstimator.from_flax(
        _JaxMLP(), loss="sparse_categorical_crossentropy", optimizer=jopt,
        learning_rate=lr, clip_norm=clip_norm, clip_value=clip_value)
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, tree))
    jest.fit(data, epochs=2, batch_size=8, shuffle=False)

    def fit(**clips):
        est = Estimator.from_torch(
            _MLP(tree), loss="sparse_categorical_crossentropy",
            optimizer=opt, learning_rate=lr, **clips)
        est.fit(data, epochs=2, batch_size=8, shuffle=False)
        return est

    est = fit(clip_norm=clip_norm, clip_value=clip_value)
    assert est.engine.host_step == 6
    np.testing.assert_allclose([s["loss"] for s in est.train_summary],
                               [s["loss"] for s in jest.train_summary],
                               atol=F32_TOL, rtol=0)
    got, want = est.get_model().tree(), jax.device_get(jest.get_model())
    moved = 0.0
    for n in ("fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            w = np.asarray(want[n][leaf])
            np.testing.assert_allclose(got[n][leaf], w, atol=F32_TOL, rtol=0,
                                       err_msg=f"{n}.{leaf}")
            moved = max(moved, np.abs(w - tree[n][leaf]).max())
    assert moved > 1e-3
    if clip_norm or clip_value:
        free = fit().get_model().tree()
        assert max(np.abs(free[n][leaf] - got[n][leaf]).max()
                   for n in free for leaf in free[n]) > 1e-3
