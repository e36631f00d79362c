"""The port's pretrained-BERT import and export
(models/bert_pretrained.py) held against the JAX package's, and the
Estimator's `set_params` / `get_model_state` (orca/learn/estimator.py).

Both sides start from the same fresh flax tree (`convert.init_bert_params`
has the JAX module's tree and shapes): JAX's `load_bert_pretrained` fills
it, the port's fills the port model's state_dict (or the tree itself),
and the results must be equal bit for bit through `bert_from_flax`, in
both name schemes (HF, TF1) and file formats (.npz, torch .bin,
.safetensors where that package is installed).  Position slicing, a
vocab mismatch and `strict=False` behave as JAX's, with its error
types.  The Estimator checks are exact."""

import os

import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.models import bert_pretrained as jax_bp
from analytics_zoo_tpu_torch.convert import (
    bert_from_flax,
    bert_to_flax,
    init_bert_params,
)
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.models.bert_pretrained import (
    export_bert_weights,
    load_bert_pretrained,
    read_pretrained,
)
from analytics_zoo_tpu_torch.orca.learn import Estimator

CFG = dict(vocab=50, hidden_size=8, n_block=2, intermediate_size=16,
           max_position_len=16, num_classes=2)


def _tree(seed, **kw):
    return init_bert_params(dict(CFG, **kw), seed)


def _model(tree, **kw):
    cfg = dict(CFG, **kw)
    m = BERTClassifier(**cfg, n_head=2, hidden_drop=0.0, attn_drop=0.0,
                       compute_dtype=torch.float32, device="cpu")
    m.load_state_dict(bert_from_flax(tree, cfg))
    return m


def _sd_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def _tree_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _tree_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("fmt", ["hf", "tf1"])
def test_export_matches_jax_and_round_trips(fmt):
    src = _tree(0)
    named = export_bert_weights(_model(src), fmt=fmt)
    want = jax_bp.export_bert_weights(src, fmt=fmt)
    assert named.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(named[k], want[k])
    probe = ("bert.encoder.layer.0.attention.self.query.weight"
             if fmt == "hf" else
             "bert/encoder/layer_0/attention/self/query/kernel")
    assert probe in named
    # export -> load reproduces the encoder; the head keeps the fresh init
    fresh = _model(_tree(1))
    loaded = load_bert_pretrained(fresh.state_dict(), named)
    sd = _model(src).state_dict()
    for k, v in loaded.items():
        want_v = fresh.state_dict()[k] if k.startswith("classifier.") \
            else sd[k]
        assert torch.equal(v, want_v), k


@pytest.mark.parametrize("kind", ["npz_tf1", "bin_hf"])
def test_loaded_trees_equal_jax(tmp_path, kind):
    src, fresh = _tree(0), _tree(1)
    fmt = "tf1" if kind == "npz_tf1" else "hf"
    named = jax_bp.export_bert_weights(src, fmt=fmt)
    if kind == "npz_tf1":
        path = str(tmp_path / "bert.npz")
        np.savez(path, **named)
    else:
        path = str(tmp_path / "pytorch_model.bin")
        torch.save({k: torch.from_numpy(v) for k, v in named.items()}, path)
    got = read_pretrained(str(tmp_path))
    want = jax_bp.read_pretrained(str(tmp_path))
    assert got.keys() == want.keys()
    jax_loaded = jax_bp.load_bert_pretrained(fresh, path)
    # the port's state_dict, its module, and a flax tree
    model = _model(fresh)
    _sd_equal(load_bert_pretrained(model.state_dict(), path),
              bert_from_flax(jax_loaded, CFG))
    _sd_equal(load_bert_pretrained(model, path),
              bert_from_flax(jax_loaded, CFG))
    _tree_equal(load_bert_pretrained(fresh, path), jax_loaded)


def test_safetensors_file(tmp_path):
    save_file = pytest.importorskip("safetensors.numpy").save_file
    src, fresh = _tree(0), _tree(2)
    path = str(tmp_path / "model.safetensors")
    save_file(export_bert_weights(_model(src), fmt="hf"), path)
    _sd_equal(load_bert_pretrained(_model(fresh).state_dict(), path),
              bert_from_flax(jax_bp.load_bert_pretrained(fresh, path), CFG))


def test_position_slicing_vocab_and_strict_as_jax():
    big = _tree(0, max_position_len=64)
    named = export_bert_weights(_model(big, max_position_len=64), fmt="hf")
    small = _tree(1)
    got = load_bert_pretrained(_model(small).state_dict(), named)
    np.testing.assert_array_equal(
        got["bert.position_embed.weight"].numpy(),
        big["bert"]["position_embed"]["embedding"][:16])
    _sd_equal(got, bert_from_flax(jax_bp.load_bert_pretrained(small, named),
                                  CFG))
    other_vocab = _tree(1, vocab=40)
    with pytest.raises(ValueError, match="vocab|shape") as mine:
        load_bert_pretrained(_model(other_vocab, vocab=40), named)
    with pytest.raises(ValueError) as theirs:
        jax_bp.load_bert_pretrained(other_vocab, named)
    assert str(mine.value) == str(theirs.value)

    partial = {k: v for k, v in named.items() if ".layer.1." not in k}
    fresh = _tree(2)
    for fn, arg in ((load_bert_pretrained, _model(fresh)),
                    (jax_bp.load_bert_pretrained, fresh)):
        with pytest.raises(ValueError, match="layer 1"):
            fn(arg, partial)
    got = load_bert_pretrained(_model(fresh), partial, strict=False)
    _sd_equal(got, bert_from_flax(jax_bp.load_bert_pretrained(
        fresh, partial, strict=False), CFG))
    with pytest.raises(ValueError, match="encoder"):
        load_bert_pretrained(fresh, named, encoder="encoder")
    with pytest.raises(ValueError, match="fmt"):
        export_bert_weights(fresh, fmt="onnx")


def test_unrolled_layout_as_jax():
    src = _tree(0)
    named = export_bert_weights(src, fmt="hf")
    unrolled = bert_to_flax(_model(_tree(1)).state_dict(), CFG,
                            stacked=False)
    got = load_bert_pretrained(unrolled, named)
    _tree_equal(got, jax_bp.load_bert_pretrained(unrolled, named))
    np.testing.assert_array_equal(got["bert"]["block_1"]["fc1"]["kernel"],
                                  src["bert"]["blocks"]["fc1"]["kernel"][1])
    _tree_equal(export_bert_weights(got, fmt="tf1"),
                jax_bp.export_bert_weights(got, fmt="tf1"))


def test_set_params_through_the_estimator(tmp_path):
    """`est.set_params(lambda p: load_bert_pretrained(p, dir))`, as the
    JAX docstring has it: the encoder from the file, the head kept."""
    src = _tree(0)
    torch.save({k: torch.from_numpy(v) for k, v in
                export_bert_weights(src, fmt="hf").items()},
               os.path.join(tmp_path, "pytorch_model.bin"))
    model = _model(_tree(1))
    head = model.classifier.weight.detach().clone()
    est = Estimator.from_torch(model, learning_rate=1e-3)
    est.set_params(lambda p: load_bert_pretrained(p, str(tmp_path)))
    want = _model(src).state_dict()
    for k, v in model.state_dict().items():
        if k.startswith("bert."):
            assert torch.equal(v, want[k]), k
    assert torch.equal(model.classifier.weight, head)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(4, 2)
        self.norm = nn.BatchNorm1d(2)

    def forward(self, x):
        return self.norm(self.dense(x))


def _est():
    torch.manual_seed(0)
    return Estimator.from_torch(_Net(), loss="sparse_categorical_crossentropy",
                                optimizer="sgd", learning_rate=0.1)


def test_set_params_and_load_order_last_call_wins(tmp_path):
    """JAX's test_deferred_set_params_and_load_order on the port's eager
    engine: of load and set_params the last call wins, and the
    optimizer state is kept."""
    x = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    base = _est()
    base.fit({"x": x, "y": y}, epochs=1, batch_size=16)
    ckpt = str(tmp_path / "ck")
    base.save(ckpt)
    trained = {k: v.clone() for k, v in base.get_model().state_dict().items()}
    custom = {"dense.weight": torch.full((2, 4), 7.0),
              "dense.bias": torch.zeros(2), "norm.weight": torch.ones(2),
              "norm.bias": torch.zeros(2)}

    e1 = _est()
    e1.set_params(custom)
    assert (e1.get_model().dense.weight == 7.0).all()
    e1.load(ckpt)
    assert torch.equal(e1.get_model().dense.weight, trained["dense.weight"])

    e2 = _est()
    e2.load(ckpt)
    e2.set_params(lambda sd: dict(sd, **custom))
    assert (e2.get_model().dense.weight == 7.0).all()
    # a callable gets the current state_dict; buffers it names load too
    assert torch.equal(e2.get_model().norm.running_mean,
                       trained["norm.running_mean"])
    with pytest.raises(ValueError, match="dense.bias"):
        e2.set_params({"dense.weight": torch.zeros(2, 4)})
    with pytest.raises(ValueError, match="extra"):
        e2.set_params(dict(custom, extra=torch.zeros(1)))
    assert (e2.get_model().dense.weight == 7.0).all()


def test_set_params_keeps_the_optimizer_state():
    x = np.random.default_rng(2).normal(size=(32, 4)).astype(np.float32)
    torch.manual_seed(0)
    est = Estimator.from_torch(_Net(), loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=0.1)
    est.fit({"x": x, "y": (x[:, 0] > 0).astype(np.int32)}, epochs=1,
            batch_size=16)
    before = {k: {n: t.clone() for n, t in v.items()}
              for k, v in est.engine.opt.state_dict()["state"].items()}
    est.set_params(lambda sd: {k: v + 1.0 if v.is_floating_point() else v
                               for k, v in sd.items()})
    after = est.engine.opt.state_dict()["state"]
    assert before.keys() == after.keys()
    for k, v in before.items():
        for n, t in v.items():
            assert torch.equal(t, after[k][n]), (k, n)


def test_get_model_state_is_the_buffers():
    est = _est()
    x = np.random.default_rng(1).normal(3.0, 1.0, (32, 4)).astype(np.float32)
    est.fit({"x": x, "y": np.zeros(32, np.int32)}, epochs=1, batch_size=16)
    state = est.get_model_state()
    assert set(state) == {"norm.running_mean", "norm.running_var",
                          "norm.num_batches_tracked"}
    assert torch.equal(state["norm.running_mean"],
                       est.get_model().norm.running_mean)
    assert state["norm.running_mean"].abs().sum() > 0
    state["norm.running_mean"].zero_()     # a copy
    assert est.get_model().norm.running_mean.abs().sum() > 0
