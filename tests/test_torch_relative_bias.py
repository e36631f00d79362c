"""The port's `RelativePositionBias` (keras/layers/self_attention.py, the
learnable T5 bias whose gradient runs through the flash dbias pass)
held against the JAX module on the same table: its distance buckets,
its gathered [1, h, t, t] bias, and the table's gradient through flash
attention (the JAX side's Pallas kernels in interpret mode, forward and
backward, with explicit block sizes).

Tolerances, each with its reason:
  * buckets and the gathered bias are exact: integer arithmetic, and a
    log in f32 on both sides, then a gather;
  * the table's gradient 1e-5 of its largest element: each entry sums
    the f32 dbias of up to t*t / 2 cells (the same f32 arithmetic, in
    other orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.keras.layers.self_attention import (
    RelativePositionBias as JaxBias,
)
from analytics_zoo_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash,
)
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    RelativePositionBias,
)
from analytics_zoo_tpu_torch.ops.attention import flash_attention

B, H, D, T = 2, 2, 32, 128


def _bias(table, causal):
    mod = RelativePositionBias(table.shape[0], num_buckets=table.shape[1],
                               causal=causal, device="cpu")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(table))
    return mod


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 40)])
def test_bucket_matches_jax(causal, num_buckets, max_distance):
    """t = 300 reaches past max_distance, so the log-spaced buckets and
    the clamp to the last bucket are both exercised."""
    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(JaxBias.bucket(jnp.asarray(rel), num_buckets,
                                     max_distance, causal))
    got = RelativePositionBias.bucket(torch.from_numpy(rel), num_buckets,
                                      max_distance, causal)
    np.testing.assert_array_equal(got.numpy(), want)
    # every bucket is reached, but for the later half's first (a
    # positive distance of 0) when the sign splits them
    assert len(np.unique(want)) == num_buckets - (not causal)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(causal):
    t = 200
    table = np.random.default_rng(1).normal(size=(3, 32)).astype(np.float32)
    want = JaxBias(n_head=3, causal=causal).apply(
        {"params": {"rel_bias": jnp.asarray(table)}}, t)
    got = _bias(table, causal)(t)
    assert got.shape == (1, 3, t, t) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("causal", [False, True])
def test_table_grad_through_flash_matches_jax(causal):
    """The bias as flash's [1, h, t, t] bias beside a kv_mask with a
    padded tail: the table gets the gather's scatter-add of dbias."""
    rng = np.random.default_rng(5)
    q, k, v, go = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                   for _ in range(4))
    table = (0.5 * rng.normal(size=(H, 32))).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 70:] = 0

    def loss(tab):
        bias = JaxBias(n_head=H, causal=causal).apply(
            {"params": {"rel_bias": tab}}, T)
        out = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        bias=bias, kv_mask=jnp.asarray(mask), causal=causal,
                        block_q=64, block_k=128, bwd_block_q=64,
                        bwd_block_k=128, interpret=True)
        return (out * jnp.asarray(go)).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    mod = _bias(table, causal)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          bias=mod(T), kv_mask=torch.from_numpy(mask),
                          causal=causal)
    (out * torch.from_numpy(go)).sum().backward()
    got = mod.weight.grad.numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
