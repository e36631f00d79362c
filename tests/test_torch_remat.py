"""Rematerialization in the port (`TransformerEncoder(remat=True,
remat_policy=...)`, analytics_zoo_tpu_torch/keras/layers/
self_attention.py): each block under non-reentrant
`torch.utils.checkpoint`, its recompute drawing its dropout masks and
flash seeds from a fork of the generator at the block's entry.

  * remat on against off, dropout on, the same generator seed: loss,
    every gradient and the generator's state after the step are
    bitwise equal under each policy (the plain path recomputes the same
    f32 arithmetic on the same inputs);
  * the port with remat against the JAX `TransformerEncoder(remat=True)`
    on converted weights, dropout off, f32: loss and gradients at the
    JAX remat test's tolerance (test_attention_parallel.py's
    test_remat_encoder_matches_no_remat: rtol 1e-4, atol 1e-5);
  * the JAX module's two ValueErrors;
  * the bytes the forward leaves alive for the backward: recompute
    everything < save the products without batch dimensions <= save
    every product < no remat.  They are counted as the storages made
    during the forward that are still alive after it (a dispatch mode
    keeps a weak reference to each): `saved_tensors_hooks` cannot see
    them, because the checkpoint's own hook is the innermost one inside
    each block and a selective policy keeps its saves in its own cache.
"""

import gc

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import flax.linen as fnn
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.keras.layers.self_attention import (
    TransformerEncoder as JaxEncoder,
)
from analytics_zoo_tpu_torch.convert import (
    bert_from_flax,
    bert_to_flax,
    init_bert_params,
)
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    TransformerEncoder,
)
from analytics_zoo_tpu_torch.models.bert import (
    BERTClassifier,
    BERTNER,
    BERTSQuAD,
)

CFG = dict(vocab=100, hidden_size=32, n_head=2, n_block=2,
           intermediate_size=64, max_position_len=64)
B, T = 4, 64
POLICIES = [None, "dots", "dots_all"]


def _inputs(seed=0, t=T):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab"], (B, t)).astype(np.int64)
    seg = (np.arange(t)[None] >= t // 2).astype(np.int64).repeat(B, 0)
    lens = rng.integers(t // 2, t + 1, B)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int64)
    y = rng.integers(0, 2, B)
    return [torch.from_numpy(a) for a in (ids, seg, mask)], \
        torch.from_numpy(y)


def _model(attn_impl, remat=False, policy=None, **kw):
    cfg = dict(CFG, num_classes=2)
    m = BERTClassifier(**CFG, attn_impl=attn_impl, remat=remat,
                       remat_policy=policy, compute_dtype=torch.float32,
                       device="cpu", **kw)
    m.load_state_dict(bert_from_flax(init_bert_params(cfg, seed=1), cfg))
    return m.train()


class _Alive(TorchDispatchMode):
    """Every storage an op makes while the mode is on, weakly held."""

    def __init__(self):
        super().__init__()
        self.storages = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.storages.setdefault(
                    st.data_ptr(), (StorageWeakRef(st), st.nbytes()))
        return out

    def alive_bytes(self):
        gc.collect()
        return sum(n for ref, n in self.storages.values()
                   if not ref.expired())


def _step(model, seed=5):
    """One step's loss, gradients, generator state after it, and the
    bytes the forward left alive for the backward."""
    inputs, y = _inputs()
    gen = torch.Generator().manual_seed(seed)
    track = _Alive()
    with track:
        loss = F.cross_entropy(model(*inputs, generator=gen), y)
    alive = track.alive_bytes()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.detach(), grads, gen.get_state(), alive


@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_replays_the_step_bitwise(policy, attn_impl):
    """Dropout 0.1 everywhere (embeddings, attention, residuals, the
    pooled output): remat changes when the block's activations are
    computed, never what, and leaves the generator where no remat does."""
    loss0, grads0, state0, _ = _step(_model(attn_impl))
    loss, grads, state, _ = _step(_model(attn_impl, True, policy))
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for name in grads0:
        assert torch.equal(grads[name], grads0[name]), name
    assert torch.equal(state, state0)
    # the next step draws the same masks: run a second step on each
    m0, m1 = _model(attn_impl), _model(attn_impl, True, policy)
    gen0, gen1 = torch.Generator().manual_seed(5), \
        torch.Generator().manual_seed(5)
    inputs, y = _inputs()
    for _ in range(2):
        l0 = F.cross_entropy(m0(*inputs, generator=gen0), y)
        l1 = F.cross_entropy(m1(*inputs, generator=gen1), y)
        l1.backward()
        assert torch.equal(l0.detach(), l1.detach())


@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_remat_saves_less_for_the_backward(attn_impl):
    """Live bytes after the forward: None < "dots" <= "dots_all" < no
    remat.  On the flash path the CPU runs flash's plain version, whose
    batched products inside its autograd Function "dots_all" saves too
    (more than the Function itself keeps); the kernel on the card has no
    aten product to save, so there "dots_all" equals "dots" (held below
    no remat on the card).  Here the flash path holds "dots" < no remat,
    and the einsum path the whole order."""
    off = _step(_model(attn_impl))[3]
    by = {p: _step(_model(attn_impl, True, p))[3] for p in POLICIES}
    assert by[None] < by["dots"] <= by["dots_all"], by
    assert by["dots"] < off, (by, off)
    if attn_impl == "einsum":
        assert by["dots_all"] < off, (by, off)


def test_remat_policy_errors():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TransformerEncoder(**CFG, remat=True, remat_policy="nope",
                           device="cpu")
    with pytest.raises(ValueError, match="remat_policy is set"):
        TransformerEncoder(**CFG, remat_policy="dots", device="cpu")
    for cls in (BERTClassifier, BERTNER, BERTSQuAD):
        with pytest.raises(ValueError, match="remat_policy is set"):
            cls(**CFG, remat_policy="dots_all", device="cpu")
        assert cls(**CFG, remat=True, remat_policy="dots",
                   device="cpu").bert.remat_policy == "dots"


class _JaxRematClassifier(fnn.Module):
    """The JAX `BERTClassifier`'s tree with remat on, compute_dtype f32
    and dropout off."""
    policy: str = None

    @fnn.compact
    def __call__(self, ids, seg, mask):
        _, pooled = JaxEncoder(**CFG, n_segments=2, with_pooler=True,
                               compute_dtype=jnp.float32, remat=True,
                               remat_policy=self.policy,
                               embedding_dropout=0.0, attn_dropout=0.0,
                               residual_dropout=0.0, name="bert")(
            ids, seg, None, mask, True)
        return fnn.Dense(2, name="classifier")(pooled)


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_matches_the_jax_encoder(policy):
    """Sum of squared logits through 2 rematerialized blocks, einsum
    attention with a key mask, f32: loss and every gradient against JAX
    (rtol 1e-4, atol 1e-5, the JAX remat test's tolerance)."""
    cfg = dict(CFG, num_classes=2)
    tree = init_bert_params(cfg, seed=2)
    inputs, _ = _inputs(seed=3, t=32)
    np_in = [a.numpy().astype(np.int32) for a in inputs]

    def jloss(params):
        out = _JaxRematClassifier(policy).apply({"params": params}, *np_in)
        return jnp.sum(out ** 2)

    jl, jg = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = BERTClassifier(**CFG, hidden_drop=0.0, attn_drop=0.0,
                           remat=True, remat_policy=policy,
                           compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(bert_from_flax(tree, cfg))
    loss = (model(*inputs) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4,
                               atol=1e-5)
    ours = bert_to_flax({n: p.grad for n, p in model.named_parameters()},
                        cfg)
    flat = dict(jax.tree_util.tree_leaves_with_path(ours))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(jg))
    assert len(flat) == len(want)
    for path, w in want:
        np.testing.assert_allclose(flat[path], np.asarray(w), rtol=1e-4,
                                   atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_is_off_without_grad():
    """Under no_grad (evaluate, predict) the blocks run as they are:
    the same logits as a model without remat."""
    inputs, _ = _inputs()
    plain, rem = _model("flash").eval(), _model("flash", True, "dots").eval()
    with torch.no_grad():
        assert torch.equal(plain(*inputs), rem(*inputs))
