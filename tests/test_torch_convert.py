"""The port's CausalLM (analytics_zoo_tpu_torch/serving/generation/
model.py) on weights converted from a JAX `CausalLM.init` tree
(analytics_zoo_tpu_torch/convert.py), held against JAX `model.apply` in
its four modes — prefill with a token mask, paged decode over a block
pool (f32 and int8), paged verify (t > 1) and the concat/ctx read
path — plus the numpy-only
initializer's tree against JAX `init`.  Tolerance 1e-4 on logits and
1e-5 on the returned K/V (f32 on both sides; the matmuls sum in other
orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.serving.generation import CausalLM as JaxCausalLM
from analytics_zoo_tpu.serving.generation.kv_cache import (
    quantize_kv_tokens as jax_quantize,
)
from analytics_zoo_tpu_torch.convert import (
    causal_lm_from_flax,
    init_causal_lm_params,
)
from analytics_zoo_tpu_torch.serving.generation import CausalLM

CFG = dict(vocab=61, hidden_size=32, n_head=4, n_block=2,
           intermediate_size=64, max_position_len=128)
LOGIT_TOL, KV_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def pair():
    torch.backends.cuda.matmul.allow_tf32 = False
    jm = JaxCausalLM(**CFG)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                     jnp.arange(8)[None])["params"]
    tm = CausalLM(**CFG, device="cpu")
    tm.load_state_dict(causal_lm_from_flax(
        jax.tree_util.tree_map(np.asarray, params), CFG))
    return jm, params, tm.eval()


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def test_prefill_with_token_mask(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(0)
    b, t = 3, 11
    ids = rng.integers(0, CFG["vocab"], (b, t)).astype(np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    mask = np.ones((b, t), np.float32)
    mask[1, 7:] = 0
    mask[2, 2:] = 0
    jl, jk, jv = jm.apply({"params": params}, ids, pos,
                          token_mask=jnp.asarray(mask))
    with torch.no_grad():
        tl, tk, tv = tm(torch.from_numpy(ids), torch.from_numpy(pos),
                        token_mask=torch.from_numpy(mask))
    assert tl.dtype == torch.float32 and tl.shape == (b, t, CFG["vocab"])
    assert tk.shape == (CFG["n_block"], b, t, 4, 8)
    _close(tl, jl, LOGIT_TOL)
    _close(tk, jk, KV_TOL)
    _close(tv, jv, KV_TOL)


def _pool_scene(seed, quantized):
    """A block pool written with a real prefix's K/V (from a JAX
    prefill) plus garbage elsewhere; lanes with ragged ctx_len."""
    rng = np.random.default_rng(seed)
    L, h, hd = CFG["n_block"], CFG["n_head"], 8
    bs, mb, S = 4, 5, 3
    nb = S * mb + 1
    kv = rng.normal(size=(L, 2, nb, bs, h, hd)).astype(np.float32)
    ctx = np.array([0, 6, 13], np.int32)
    tables = np.zeros((S, mb), np.int32)
    perm = 1 + rng.permutation(nb - 1)
    for s in range(S):
        used = -(-int(ctx[s]) // bs)
        tables[s, :used] = perm[s * mb:s * mb + used]
    ids = rng.integers(0, CFG["vocab"], (S, 1)).astype(np.int32)
    scale = None
    if quantized:
        q, sc = jax_quantize(jnp.asarray(kv))
        kv, scale = np.array(q), np.array(sc)
    return kv, scale, tables, ctx, ids


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_decode_mode(pair, quantized):
    jm, params, tm = pair
    kv, scale, tables, ctx, ids = _pool_scene(1 + quantized, quantized)
    pos = ctx[:, None]
    jl, jk, jv = jm.apply(
        {"params": params}, ids, pos, kv_pool=jnp.asarray(kv),
        kv_scale=None if scale is None else jnp.asarray(scale),
        block_tables=jnp.asarray(tables), ctx_len=jnp.asarray(ctx))
    with torch.no_grad():
        tl, tk, tv = tm(
            torch.from_numpy(ids), torch.from_numpy(pos),
            kv_pool=torch.from_numpy(kv),
            kv_scale=None if scale is None else torch.from_numpy(scale),
            block_tables=torch.from_numpy(tables),
            ctx_len=torch.from_numpy(ctx))
    _close(tl, jl, LOGIT_TOL)
    _close(tk, jk, KV_TOL)
    _close(tv, jv, KV_TOL)


def test_ctx_read_mode(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(2)
    L, b, c, t = CFG["n_block"], 2, 9, 3
    ck = rng.normal(size=(L, b, c, 4, 8)).astype(np.float32)
    cv = rng.normal(size=(L, b, c, 4, 8)).astype(np.float32)
    ctx = np.array([5, 9], np.int32)
    ids = rng.integers(0, CFG["vocab"], (b, t)).astype(np.int32)
    pos = (ctx[:, None] + np.arange(t)[None]).astype(np.int32)
    jl, jk, jv = jm.apply({"params": params}, ids, pos, ctx_k=ck,
                          ctx_v=cv, ctx_len=ctx)
    with torch.no_grad():
        tl, tk, tv = tm(torch.from_numpy(ids), torch.from_numpy(pos),
                        ctx_k=torch.from_numpy(ck),
                        ctx_v=torch.from_numpy(cv),
                        ctx_len=torch.from_numpy(ctx))
    _close(tl, jl, LOGIT_TOL)
    _close(tk, jk, KV_TOL)
    _close(tv, jv, KV_TOL)


def test_paged_verify_is_not_ported_yet(pair):
    """The paged branch at t > 1 (speculative verify), which raised
    before it was ported, now runs `paged_verify_attention` and matches
    JAX `model.apply` on the same pool."""
    jm, params, tm = pair
    kv, _, tables, ctx, _ = _pool_scene(3, False)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, CFG["vocab"], (3, 2)).astype(np.int32)
    pos = (ctx[:, None] + np.arange(2)[None]).astype(np.int32)
    jl, jk, jv = jm.apply(
        {"params": params}, ids, pos, kv_pool=jnp.asarray(kv),
        block_tables=jnp.asarray(tables), ctx_len=jnp.asarray(ctx))
    with torch.no_grad():
        tl, tk, tv = tm(torch.from_numpy(ids), torch.from_numpy(pos),
                        kv_pool=torch.from_numpy(kv),
                        block_tables=torch.from_numpy(tables),
                        ctx_len=torch.from_numpy(ctx))
    _close(tl, jl, LOGIT_TOL)
    _close(tk, jk, KV_TOL)
    _close(tv, jv, KV_TOL)


def test_init_tree_matches_jax_init():
    """Same keys, nesting, shapes and dtypes as JAX `init`; LayerNorm
    and bias leaves at their init values; deterministic in the seed."""
    cfg = dict(CFG, n_block=3, intermediate_size=48)
    jparams = JaxCausalLM(**cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
        jnp.arange(4)[None])["params"]
    ours = init_causal_lm_params(cfg, seed=0)
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(ours),
            jax.tree_util.tree_leaves_with_path(jparams)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert (ours["block_2_ln1"]["scale"] == 1).all()
    assert (ours["lm_head"]["bias"] == 0).all()
    again = init_causal_lm_params(cfg, seed=0)
    np.testing.assert_array_equal(ours["block_0_qkv"]["kernel"],
                                  again["block_0_qkv"]["kernel"])
    other = init_causal_lm_params(cfg, seed=1)
    assert not np.array_equal(ours["block_0_qkv"]["kernel"],
                              other["block_0_qkv"]["kernel"])
    # and the port loads it
    m = CausalLM(**cfg, device="cpu")
    m.load_state_dict(causal_lm_from_flax(ours, cfg))
    torch.testing.assert_close(m.blocks[1].fc1.weight,
                               torch.from_numpy(
                                   ours["block_1_fc1"]["kernel"].T.copy()))


def test_convert_rejects_mismatched_trees():
    tree = init_causal_lm_params(CFG, seed=0)
    with pytest.raises(ValueError, match="shape"):
        causal_lm_from_flax(tree, dict(CFG, hidden_size=16))
    extra = dict(tree, block_9_qkv=tree["block_0_qkv"])
    with pytest.raises(ValueError, match="unknown entries"):
        causal_lm_from_flax(extra, CFG)
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(KeyError):
        causal_lm_from_flax(missing, CFG)
