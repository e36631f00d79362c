"""The port's transformer stack and BERT family
(analytics_zoo_tpu_torch/keras/layers/self_attention.py, models/bert.py)
on weights converted from flax trees (convert.py), held against the JAX
modules' `apply` on the same numpy inputs, at 2 blocks, hidden 64, 4
heads, t <= 64.  The flash impl on the JAX side runs its Pallas kernel
in interpret mode (t = 64 tiles its blocks).

Tolerances: compute_dtype f32, 1e-4 absolute (f32 throughout; the
matmuls and softmax sum in other orders).  The default bf16, 0.05
absolute on logits of size up to ~4: both sides round the four dense
outputs and the attention operands to bf16, but at different places
(XLA adds the bias and the GELU in bf16, the port's fused op in f32;
flash casts other probabilities); 2 blocks of such roundings moved the
logits here by up to 0.019."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.keras.layers.self_attention import (
    TransformerEncoder as JaxEncoder,
)
from analytics_zoo_tpu.models.bert import BERTClassifier as JaxClassifier
from analytics_zoo_tpu.models.bert import BERTNER as JaxNER
from analytics_zoo_tpu.models.bert import BERTSQuAD as JaxSQuAD
from analytics_zoo_tpu_torch.convert import (
    bert_from_flax,
    bert_to_flax,
    init_bert_params,
)
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    MultiHeadAttention,
)
from analytics_zoo_tpu_torch.models.bert import (
    BERTNER,
    BERTClassifier,
    BERTSQuAD,
)

CFG = dict(vocab=53, hidden_size=64, n_head=4, n_block=2,
           intermediate_size=128, max_position_len=64)
F32_TOL, BF16_TOL = 1e-4, 0.05
HEADS = {"classifier": (JaxClassifier, BERTClassifier, dict(num_classes=3)),
         "ner_head": (JaxNER, BERTNER, dict(num_entities=5)),
         "span_head": (JaxSQuAD, BERTSQuAD, {})}


def _params(head, seed=0):
    """init_bert_params, with LayerNorm scales and biases moved off
    ones/zeros so every parameter matters."""
    cfg = dict(CFG, **HEADS[head][2])
    tree = init_bert_params(cfg, seed=seed, head=head)
    rng = np.random.default_rng(seed + 100)
    bert = tree["bert"]
    for ln in (bert["embed_ln"], bert["blocks"]["ln1"],
               bert["blocks"]["ln2"]):
        ln["scale"] = ln["scale"] + rng.normal(
            0, 0.1, ln["scale"].shape).astype(np.float32)
        ln["bias"] = rng.normal(0, 0.1, ln["bias"].shape).astype(np.float32)
    return cfg, tree


def _batch(b=3, t=40, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab"], (b, t)).astype(np.int32)
    seg = (np.arange(t)[None] >= t // 2).astype(np.int32).repeat(b, 0)
    mask = np.ones((b, t), np.int32)
    mask[1, 25:] = 0
    mask[2, 9:] = 0
    return ids, seg, mask


def _port(cls, cfg, tree, **kw):
    model = cls(**cfg, device="cpu", **kw)
    model.load_state_dict(bert_from_flax(tree, cfg))
    return model.eval()


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_encoder_f32_matches_jax(attn_impl):
    cfg, tree = _params("classifier")
    ids, seg, mask = _batch(t=64)
    enc = JaxEncoder(**CFG, n_segments=2, with_pooler=True,
                     attn_impl=attn_impl, compute_dtype=jnp.float32)
    jx, jpooled = enc.apply({"params": tree["bert"]}, jnp.asarray(ids),
                            jnp.asarray(seg), None, jnp.asarray(mask))
    model = _port(BERTClassifier, cfg, tree, attn_impl=attn_impl,
                  compute_dtype=torch.float32)
    with torch.no_grad():
        tx, tpooled = model.bert(torch.from_numpy(ids),
                                 torch.from_numpy(seg), None,
                                 torch.from_numpy(mask))
    assert tx.dtype == torch.float32 and tuple(tx.shape) == (3, 64, 64)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(jpooled),
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_heads_bf16_match_jax(head, attn_impl):
    jcls, tcls, extra = HEADS[head]
    cfg, tree = _params(head, seed=1)
    ids, seg, mask = _batch(t=64, seed=2)
    jm = jcls(**CFG, **extra, attn_impl=attn_impl)
    want = jm.apply({"params": tree}, jnp.asarray(ids), jnp.asarray(seg),
                    jnp.asarray(mask))
    model = _port(tcls, cfg, tree, attn_impl=attn_impl)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(seg),
                    torch.from_numpy(mask))
    if head != "span_head":
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BF16_TOL,
                                   rtol=0)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_init_has_the_jax_tree_shapes(head):
    jcls, _, extra = HEADS[head]
    cfg = dict(CFG, **extra)
    jtree = jcls(**CFG, **extra).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 8), jnp.int32))["params"]
    ours = init_bert_params(cfg, seed=3, head=head)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jtree)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), ours) == shapes
    assert all(a.dtype == np.float32
               for a in jax.tree_util.tree_leaves(ours))


def test_both_param_layouts_convert():
    """The unrolled `block_{i}` tree of a `scan_layers=False` encoder
    converts to the same state_dict as the scan-stacked one."""
    cfg, tree = _params("ner_head", seed=4)
    enc = JaxEncoder(**CFG, n_segments=2, scan_layers=False)
    jtree = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    blocks = tree["bert"]["blocks"]
    unrolled = {k: v for k, v in tree["bert"].items() if k != "blocks"}
    for i in range(CFG["n_block"]):
        unrolled[f"block_{i}"] = jax.tree_util.tree_map(lambda a: a[i],
                                                        blocks)
    layout = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    jtree["params"])
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  unrolled) == layout
    a = bert_from_flax(tree, cfg)
    b = bert_from_flax({"bert": unrolled, "ner_head": tree["ner_head"]},
                       cfg)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_to_flax_round_trips_exactly(head, stacked):
    """bert_to_flax inverts bert_from_flax: every tensor comes back bit
    for bit, in the scan-stacked and in the unrolled block layout, and
    the stacked tree is the one the weights came from."""
    cfg, tree = _params(head, seed=5)
    sd = bert_from_flax(tree, cfg)
    back = bert_to_flax(sd, cfg, stacked=stacked)
    if stacked:
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(tree)):
            assert a.dtype == np.float32 and np.array_equal(a, b)
    else:
        assert "blocks" not in back["bert"]
        assert f"block_{CFG['n_block'] - 1}" in back["bert"]
    again = bert_from_flax(back, cfg)
    assert again.keys() == sd.keys()
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


def test_to_flax_rejects_bad_state_dicts():
    cfg, tree = _params("classifier")
    sd = bert_from_flax(tree, cfg)
    with pytest.raises(ValueError, match="config says"):
        bert_to_flax(sd, dict(cfg, hidden_size=32))
    with pytest.raises(ValueError, match="unknown entries"):
        bert_to_flax(dict(sd, extra=torch.zeros(2)), cfg)
    with pytest.raises(ValueError, match="one head"):
        bert_to_flax({k: v for k, v in sd.items()
                      if not k.startswith("classifier")}, cfg)


def test_conversion_rejects_bad_trees():
    cfg, tree = _params("classifier")
    with pytest.raises(ValueError, match="one head"):
        bert_from_flax({"bert": tree["bert"]}, cfg)
    bad = dict(tree, extra={"kernel": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="unknown entries"):
        bert_from_flax(bad, cfg)
    with pytest.raises(ValueError, match="config says"):
        bert_from_flax(tree, dict(cfg, n_block=3))


def test_ring_and_unknown_attn_impl_raise():
    with pytest.raises(NotImplementedError, match="parallel"):
        MultiHeadAttention(64, 4, attn_impl="ring", device="cpu")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        MultiHeadAttention(64, 4, attn_impl="xla", device="cpu")
