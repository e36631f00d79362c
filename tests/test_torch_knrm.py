"""The port's KNRM and Ranker (models/textmatching/knrm.py,
models/common/ranker.py) held against the JAX package's on the CPU, on
the same weights (`convert.knrm_from_flax`) and the same numpy inputs.

Tolerances, each with its reason:
  * forward scores: 1e-5 absolute, the same f32 arithmetic in other
    orders;
  * gradients: 1e-4 of each tensor's largest gradient.  The exact-match
    kernel (sigma 1e-3) multiplies a similarity's rounding by up to
    (1 - sim) / sigma^2 ~ 1e6 where a doc token nearly matches a query
    token, so each side's gradient carries its own f32 rounding at that
    gain;
  * losses and metrics: 1e-6 absolute (elementwise f32);
  * NDCG, MAP and the scores of `score_relations`: NDCG and MAP exact on
    the same scores, the scores 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models.common import ranker as jax_ranker
from analytics_zoo_tpu.models.textmatching import KNRM as JaxKNRM
from analytics_zoo_tpu.orca.data import XShards as JaxXShards
from analytics_zoo_tpu.orca.learn import losses as jax_losses
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.models.common import ranker
from analytics_zoo_tpu_torch.models.textmatching import KNRM
from analytics_zoo_tpu_torch.orca.data import XShards
from analytics_zoo_tpu_torch.orca.learn import losses

TOL, GRAD_REL = 1e-5, 1e-4
KW = dict(text1_length=4, text2_length=6, vocab_size=30, embed_dim=8,
          kernel_num=5)


def _inputs(rng, n):
    q = rng.integers(-2, KW["vocab_size"] + 3, (n, KW["text1_length"]))
    d = rng.integers(-2, KW["vocab_size"] + 3, (n, KW["text2_length"]))
    # exact matches, so the exact-match kernel carries weight
    d[:, :2] = q[:, :2]
    return q.astype(np.int32), d.astype(np.int32)


@pytest.fixture(scope="module")
def knrms():
    """{target_mode: (JAX module, its params)}: the modes share one
    tree (the mode only decides the output's sigmoid)."""
    q, d = _inputs(np.random.default_rng(0), 2)
    p = jax.tree_util.tree_map(np.array, JaxKNRM(**KW).init(
        jax.random.PRNGKey(1), q, d)["params"])
    return {mode: (JaxKNRM(**KW, target_mode=mode), p)
            for mode in ("ranking", "classification")}


def _port(mode, params):
    m = KNRM(**KW, target_mode=mode, device="cpu")
    m.load_state_dict(convert.knrm_from_flax(params))
    return m


@pytest.mark.parametrize("mode", ["ranking", "classification"])
def test_forward_and_gradient_match_jax(knrms, mode):
    jm, p = knrms[mode]
    q, d = _inputs(np.random.default_rng(2), 16)
    cot = np.random.default_rng(3).normal(size=(16, 1)).astype(np.float32)
    want, vjp = jax.vjp(lambda params: jm.apply({"params": params}, q, d), p)
    (want_grads,) = vjp(jnp.asarray(cot))
    m = _port(mode, p)
    got = m(torch.from_numpy(q), torch.from_numpy(d))
    assert got.shape == (16, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    if mode == "classification":
        assert ((got > 0) & (got < 1)).all()
    (got * torch.from_numpy(cot)).sum().backward()
    grads = convert.knrm_to_flax(
        {k: v.grad for k, v in m.named_parameters()})
    for path, w in jax.tree_util.tree_flatten_with_path(want_grads)[0]:
        g = grads
        for k in path:
            g = g[k.key]
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max())


def test_defaults_behave_as_jax(knrms):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(12, 1)).astype(np.float32)
    probs = 1.0 / (1.0 + np.exp(-logits))
    labels = rng.integers(0, 2, (12, 1)).astype(np.float32)
    for mode, preds in (("ranking", logits), ("classification", probs)):
        jm, _ = knrms[mode]
        m = KNRM(**KW, target_mode=mode, device="cpu")
        want = jax_losses.resolve(jm.default_loss)(jnp.asarray(preds),
                                                   jnp.asarray(labels))
        got = losses.resolve(m.default_loss)(torch.from_numpy(preds),
                                             torch.from_numpy(labels))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        (jmet,), (met,) = jm.default_metrics, m.default_metrics
        assert met.from_logits == jmet.from_logits == (mode == "ranking")
        np.testing.assert_array_equal(
            met(torch.from_numpy(preds), torch.from_numpy(labels)).numpy(),
            np.asarray(jmet(jnp.asarray(preds), jnp.asarray(labels))))


def test_ndcg_and_map_match_jax():
    rng = np.random.default_rng(5)
    scores = rng.normal(size=(20, 7))
    labels = rng.integers(0, 3, (20, 7)).astype(np.float32)
    labels[rng.random((20, 7)) < 0.2] = -1      # padded candidates
    labels[0] = 0                               # a query with no positive
    for k in (1, 3, 5, 10):
        assert ranker.ndcg_at_k(scores, labels, k) == \
            jax_ranker.ndcg_at_k(scores, labels, k)
    for t in (0.0, 1.0):
        assert ranker.mean_average_precision(scores, labels, t) == \
            jax_ranker.mean_average_precision(scores, labels, t)
    assert ranker.ndcg_at_k(scores[:1], labels[:1], 3) == 0.0


def test_score_relations_over_xshards_matches_jax(knrms):
    jm, p = knrms["ranking"]
    rng = np.random.default_rng(6)

    def block(nq, nc):
        q, d = _inputs(rng, nq * nc)
        x = np.concatenate([q, d], axis=1).reshape(nq, nc, -1)
        y = rng.integers(0, 2, (nq, nc)).astype(np.float32)
        return {"x": x, "y": y}
    # the second block has fewer candidates: padded with label -1
    blocks = [block(3, 5), block(2, 4)]
    jm._estimator = None
    jest = jm.estimator()
    jest.set_params(p)
    want_s, want_y = jm.score_relations(JaxXShards(blocks), batch_size=8)
    m = _port("ranking", p)
    m.estimator()
    got_s, got_y = m.score_relations(XShards(blocks), batch_size=8)
    np.testing.assert_array_equal(got_y, want_y)
    assert (got_y[3:, 4] == -1).all()
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=TOL)
    for k in (1, 3):
        assert m.evaluate_ndcg(XShards(blocks), k, batch_size=8) == \
            ranker.ndcg_at_k(got_s, got_y, k)
    assert m.evaluate_map(XShards(blocks), batch_size=8) == \
        jax_ranker.mean_average_precision(got_s, got_y)
    with pytest.raises(ValueError, match="text1_length"):
        m.score_relations({"x": blocks[0]["x"][:, :, 1:],
                           "y": blocks[0]["y"]})


def test_knrm_fits_and_round_trips(knrms, tmp_path):
    _, p = knrms["classification"]
    m = _port("classification", p)
    _leaves = jax.tree_util.tree_leaves
    for a, b in zip(_leaves(convert.knrm_to_flax(m.state_dict())),
                    _leaves(p)):
        np.testing.assert_array_equal(a, b)
    q, d = _inputs(np.random.default_rng(7), 64)
    y = (q[:, 0] % 2).astype(np.float32)
    m.fit({"x": [q, d], "y": y}, epochs=2, batch_size=16)
    assert np.isfinite(m._estimator.train_summary[-1]["loss"])
    path = m.save_model(str(tmp_path / "knrm"))
    back = KNRM.load_model(path, device="cpu")
    for (k, a), b in zip(m.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), k
    from analytics_zoo_tpu_torch.models import textmatching
    assert textmatching.KNRM is KNRM
