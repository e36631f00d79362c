"""The observability of the port's `Estimator.fit` (analytics_zoo_tpu_torch/
orca/learn/estimator.py and spmd.py) held against the JAX package's: the
same tiny fit (an f32 NeuralCF, JAX's weights converted by
`convert.ncf_from_flax`, 2 epochs with validation data) through both
Estimators, on the DRAM store and on XShards input, with each package's
`OrcaContext.observability_dir` set:

  * the same structured events, in the same order and numbers
    (`train_epoch`, `validation_epoch`), with the same fields, their
    epoch and step exact and their losses within 1e-5 (f32, the
    tolerance of `test_torch_recommendation.py`'s fits);
  * the same span nesting: every `spmd.step` span under
    `estimator.epoch` under `estimator.fit`, as many of each;
  * the dispatch ledger: `train_step` / `eval_step` calls equal to the
    steps run, each with one signature;
  * a fault at every `train.step` with a one-retry budget: the same
    `fault_injected`, `retry` and `fit_retry` events and a
    `fit_exception` bundle with the same exception and context;
  * the nonfinite sentinel (`OrcaContext.nonfinite_watchdog`) on a fit
    whose head bias holds a NaN: every step skipped, a `nonfinite_step`
    bundle a step, naming that bias first in both packages (the port's
    name mapped through `convert.ncf_to_flax`), then the same kinds of
    tensors in the same order.
"""

import json
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_observability_cases import reset_planes
from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.orca.data import XShards as JaxXShards
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.convert import ncf_from_flax, ncf_to_flax
from analytics_zoo_tpu_torch.models import recommendation as rec
from analytics_zoo_tpu_torch.orca.data import XShards
from analytics_zoo_tpu_torch.orca.learn import Estimator

F32_TOL = 1e-5
NCF_KW = dict(user_count=20, item_count=30, class_num=2, user_embed=6,
              item_embed=5, hidden_layers=(16, 8), mf_embed=4)
LR, BATCH = 1e-3, 16
_SETTINGS = ("observability_dir", "nonfinite_watchdog", "fault_plan",
             "failure_retry_times", "failure_retry_interval_s",
             "train_data_store")


@pytest.fixture(autouse=True, scope="module")
def _reset_both_packages():
    reset_planes()
    yield
    reset_planes()


@pytest.fixture(autouse=True)
def _settings():
    saved = [(ctx, {k: getattr(ctx, k) for k in _SETTINGS})
             for ctx in (OrcaContext, JaxContext)]
    reset_planes()
    yield
    for ctx, values in saved:
        for k, v in values.items():
            setattr(ctx, k, v)
    reset_planes()


def _data(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(1, NCF_KW["user_count"], n).astype(np.int32)
    i = rng.integers(1, NCF_KW["item_count"], n).astype(np.int32)
    return {"x": [u, i], "y": ((u + i) % 2).astype(np.int32)}


def _params():
    jm = jrec.NeuralCF(**NCF_KW, compute_dtype=jnp.float32)
    u = np.ones(4, np.int32)
    return jm, jax.tree_util.tree_map(
        np.array, jm.init(jax.random.PRNGKey(0), u, u)["params"])


def _estimators(params, model_dir=None):
    """(JAX's, the port's) Estimators from the same weights."""
    init_orca_context(cluster_mode="local")
    jm = jrec.NeuralCF(**NCF_KW, compute_dtype=jnp.float32)
    jest = JaxEstimator.from_flax(
        jm, loss="sparse_categorical_crossentropy", optimizer="adam",
        learning_rate=LR, metrics=["accuracy"],
        model_dir=model_dir and os.path.join(model_dir, "jax"))
    jest.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    m = rec.NeuralCF(**NCF_KW, compute_dtype=torch.float32, device="cpu")
    m.load_state_dict(ncf_from_flax(params))
    est = Estimator.from_torch(
        m, loss="sparse_categorical_crossentropy", optimizer="adam",
        learning_rate=LR, metrics=["accuracy"],
        model_dir=model_dir and os.path.join(model_dir, "port"))
    return jest, est


def _events(directory):
    with open(os.path.join(directory, "events.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [d for d in lines if d["kind"] != "span"]


def _chains(spans):
    """Counter of name chains from each spmd.step span to its root."""
    by_id = {s["span_id"]: s for s in spans}
    out = Counter()
    for s in spans:
        if s["name"] != "spmd.step":
            continue
        chain = []
        while s is not None:
            chain.append(s["name"])
            s = by_id.get(s["parent_id"])
        out[tuple(chain)] += 1
    return out


def _run_both(tmp_path, data, val, fit_kw=None, params=None,
              model_dir=None):
    """Fit both Estimators; returns ({pkg: (estimator, events, spans,
    ledger families, bundles, error)})."""
    params = _params()[1] if params is None else params
    jest, est = _estimators(params, model_dir)
    out = {}
    for pkg, e, o, ctx, d in (
            ("jax", jest, jobs, JaxContext, data[0]),
            ("port", est, obs, OrcaContext, data[1])):
        directory = str(tmp_path / pkg)
        ctx.observability_dir = directory
        err = None
        try:
            e.fit(d, epochs=2, batch_size=BATCH, shuffle=False,
                  validation_data=val and val[pkg == "port"],
                  **(fit_kw or {}))
        except Exception as ex:       # compared below, between packages
            err = ex
        o.close_sink()
        out[pkg] = (e, _events(directory), o.recent_spans(1000),
                    o.ledger_snapshot()["families"],
                    o.flight_recorder.find_bundles(directory), err)
    return out


@pytest.mark.parametrize("source", ["DRAM", "XShards"])
def test_fit_events_spans_and_ledger_match_jax(tmp_path, source):
    data, val = _data(70, 0), _data(24, 1)
    if source == "XShards":
        pair = (JaxXShards.partition(data, 3), XShards.partition(data, 3))
    else:
        pair = (data, data)
    got = _run_both(tmp_path, pair, (val, val))
    (jest, jev, jspans, jfam, _, jerr), (est, pev, pspans, pfam, _, perr) = \
        got["jax"], got["port"]
    assert jerr is None and perr is None
    assert [e["kind"] for e in pev] == [e["kind"] for e in jev] == \
        ["train_epoch", "validation_epoch"] * 2
    for g, w in zip(pev, jev):
        assert set(g) == set(w)
        assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
        assert g["loss"] == pytest.approx(w["loss"], abs=F32_TOL)
    steps = 2 * -(-70 // BATCH)
    val_steps = 2 * -(-24 // BATCH)
    chain = ("spmd.step", "estimator.epoch", "estimator.fit")
    assert _chains(pspans) == _chains(jspans) == \
        Counter({chain: steps + val_steps})
    fit = [s for s in pspans if s["name"] == "estimator.fit"]
    assert fit[0]["attrs"] == {"epochs": 2, "batch_size": BATCH}
    epochs = [s["attrs"] for s in reversed(pspans)
              if s["name"] == "estimator.epoch"]
    assert [(a["epoch"], a["step_start"], a["step"]) for a in epochs] == \
        [(0, 0, steps // 2), (1, steps // 2, steps)]
    for fam in (pfam, jfam):
        assert fam["train_step"]["calls"] == steps
        assert fam["eval_step"]["calls"] == val_steps
        assert fam["train_step"]["signatures"] == 1
        assert fam["eval_step"]["signatures"] == 1
    assert est.engine.host_step == jest._engine.host_step == steps


def test_fit_exception_bundle_after_the_retry_budget(tmp_path):
    for ctx in (OrcaContext, JaxContext):
        ctx.failure_retry_times = 1
        ctx.failure_retry_interval_s = 0.0
        ctx.fault_plan = {"faults": [{"site": "train.step", "at": 2,
                                      "action": "raise", "times": 100}]}
    data = _data(48, 2)
    got = _run_both(tmp_path, (data, data), None,
                    model_dir=str(tmp_path / "ckpt"))
    want_kinds = None
    for pkg in ("jax", "port"):
        e, events, _spans, _fam, bundles, err = got[pkg]
        assert type(err).__name__ == "SimulatedWorkerFailure"
        kinds = [ev["kind"] for ev in events]
        assert Counter(kinds) == Counter(fault_injected=2, retry=1,
                                         fit_retry=1)
        want_kinds = want_kinds or kinds
        assert kinds == want_kinds
        with open(bundles[-1]) as f:
            bundle = json.load(f)
        assert bundle["reason"] == "fit_exception"
        assert bundle["exception"]["type"] == "SimulatedWorkerFailure"
        assert bundle["extra"] == {"epoch": 0, "retries": 1}
        assert e.retries == 1


def _flax_path(port_name):
    """The JAX package's leaf path of the port's parameter `port_name`,
    through `convert.ncf_to_flax`."""
    m = rec.NeuralCF(**NCF_KW, compute_dtype=torch.float32, device="cpu")
    sd = {k: torch.zeros_like(v) for k, v in m.state_dict().items()}
    sd[port_name] = torch.full_like(sd[port_name], float("nan"))
    tree = ncf_to_flax(sd)
    hits = [jax.tree_util.keystr(p)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
            if np.isnan(np.asarray(leaf)).any()]
    assert len(hits) == 1
    return hits[0]


def test_nonfinite_sentinel_names_the_poisoned_parameter(tmp_path):
    OrcaContext.nonfinite_watchdog = JaxContext.nonfinite_watchdog = True
    params = _params()[1]
    params["head"]["bias"][1] = np.nan
    data = _data(40, 3)
    got = _run_both(tmp_path, (data, data), None, params=params)
    steps = 2 * -(-40 // BATCH)
    leaves = {}
    for pkg in ("jax", "port"):
        e, events, _spans, _fam, bundles, err = got[pkg]
        assert err is None
        assert e.train_summary[-1]["nan_steps"] == steps // 2
        assert [ev["kind"] for ev in events].count("nonfinite_step") == \
            steps
        assert len(bundles) == steps
        with open(bundles[0]) as f:
            bundle = json.load(f)
        assert bundle["reason"] == "nonfinite_step"
        leaves[pkg] = bundle["extra"]["leaves"]
    port_first = leaves["port"][0]["path"]
    assert port_first == "params:['head.bias']"
    assert leaves["jax"][0]["path"] == "params:" + _flax_path("head.bias")
    assert [lf["path"].split(":")[0] for lf in leaves["port"]] == \
        [lf["path"].split(":")[0] for lf in leaves["jax"]]
    for g, w in zip(leaves["port"], leaves["jax"]):
        if not g["path"].startswith(("params", "grads")):
            assert g == w                # the same predictions and losses
