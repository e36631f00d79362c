"""The port's flash attention (analytics_zoo_tpu_torch/ops/attention.py
`flash_attention` and ops/kernels/flash_attention.py) held against the
JAX package's `flash_attention` on the same numpy inputs, with block
sizes chosen so that its Pallas forward kernel runs (in interpret mode),
not the JAX wrapper's reference fallback: with a kv_mask, block_k is a
multiple of 128 or t itself.  On the CPU the port runs its plain
version; the CUDA kernel is held against that plain version on the card
by chip_smoke.py.

Tolerances: f32 1e-5 absolute on out and lse (the same f32 arithmetic,
the kernel's online softmax summing in another order).  bf16 2e-2
absolute on out (the Pallas kernel casts the unnormalized probabilities
to bf16, the plain version the normalized ones).  Dropout keep masks are
bit-identical: the hash is compared bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from analytics_zoo_tpu.ops.pallas.flash_attention import (
    _hash_bits as jax_hash_bits,
)
from analytics_zoo_tpu.ops.pallas.flash_attention import (
    drop_keep_mask as jax_drop_keep_mask,
)
from analytics_zoo_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash,
)
from analytics_zoo_tpu_torch.ops.attention import flash_attention
from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
    _bias_mode,
    _hash_bits,
    bias_split,
    check_args,
    drop_keep_mask,
    flash_fwd,
    flash_fwd_reference,
)

TOL, BF16_TOL = 1e-5, 2e-2
B, H, D = 2, 2, 32


def _qkv(t, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, t, H, D)).astype(dtype)
                 for _ in range(3))


def _both(q, k, v, blocks, *, jdtype=jnp.float32, tdtype=torch.float32,
          **kw):
    """(JAX Pallas (out, lse), port (out, lse)) as f32 numpy; `kw` are
    numpy arrays or plain values, handed to each side in its types."""
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    bq, bk = blocks
    jo, jl = jax_flash(*(jnp.asarray(a).astype(jdtype) for a in (q, k, v)),
                       block_q=bq, block_k=bk, bwd_block_q=bq,
                       bwd_block_k=bk, interpret=True, return_lse=True,
                       **jkw)
    to, tl = flash_attention(*(torch.from_numpy(a).to(tdtype)
                               for a in (q, k, v)), return_lse=True, **tkw)
    assert to.dtype == tdtype and tuple(tl.shape) == (B, q.shape[1], H)
    return ((np.asarray(jo.astype(jnp.float32)), np.asarray(jl)),
            (to.float().numpy(), tl.numpy()))


def _close(pair, tol=TOL):
    (jo, jl), (to, tl) = pair
    np.testing.assert_allclose(to, jo, atol=tol, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=tol, rtol=0)


def test_kv_mask_and_fully_masked_row():
    t = 128
    q, k, v = _qkv(t, seed=1)
    mask = np.ones((B, t), np.int32)
    mask[0, 77:] = 0
    mask[1, :] = 0                      # every key of batch 1 is padding
    pair = _both(q, k, v, (64, 128), kv_mask=mask)
    _close(pair)
    (jo, _), (to, _) = pair
    assert np.all(to[1] == 0) and np.all(jo[1] == 0)


@pytest.mark.parametrize("lead", [(1, 1), (1, H), (B, 1), (B, H)])
def test_each_bias_broadcast(lead):
    t = 128
    q, k, v = _qkv(t, seed=2)
    bias = np.random.default_rng(3).normal(
        size=(*lead, t, t)).astype(np.float32)
    _close(_both(q, k, v, (64, 128), bias=bias))


def test_causal_with_lse():
    t = 256
    q, k, v = _qkv(t, seed=4)
    _close(_both(q, k, v, (128, 128), causal=True))


def test_dropout_at_seed_and_position():
    """Dropout 0.3 at one dropout_seed and dropout_pos: the outputs agree
    only if the keep masks are the same bits."""
    t = 128
    q, k, v = _qkv(t, seed=5)
    mask = np.ones((B, t), np.int32)
    mask[0, 100:] = 0
    kw = dict(kv_mask=mask, causal=True, dropout_rate=0.3,
              dropout_pos=(5, 17))
    (jo, jl), _ = _both(q, k, v, (64, 128), dropout_seed=np.int32(1234),
                        **kw)
    to, tl = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             dropout_seed=torch.tensor(1234,
                                                       dtype=torch.int32),
                             return_lse=True,
                             **{n: torch.from_numpy(a) if isinstance(
                                 a, np.ndarray) else a
                                for n, a in kw.items()})
    np.testing.assert_allclose(to.numpy(), jo, atol=TOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), jl, atol=TOL, rtol=0)
    # another seed drops other probabilities
    other = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            dropout_seed=1235, kv_mask=torch.from_numpy(mask),
                            causal=True, dropout_rate=0.3,
                            dropout_pos=(5, 17))
    assert np.abs(other.numpy() - jo).max() > 1e-2


def test_t_not_a_multiple_of_128():
    t = 96
    q, k, v = _qkv(t, seed=6)
    mask = np.ones((B, t), np.int32)
    mask[1, 50:] = 0
    _close(_both(q, k, v, (32, 96), kv_mask=mask, causal=True))


def test_bf16():
    t = 128
    q, k, v = _qkv(t, seed=7)
    mask = np.ones((B, t), np.int32)
    mask[0, 64:] = 0
    (jo, jl), (to, tl) = _both(q, k, v, (64, 128), kv_mask=mask,
                               jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    np.testing.assert_allclose(to, jo, atol=BF16_TOL, rtol=0)
    # lse comes from f32 scores of the same bf16 inputs
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)


#: valid lengths at the edges of the kernel's 64-key tiles: a fully
#: padded row, one valid key, a row ending on a tile's last key and on the
#: next tile's first, and the same one tile further on
PADDED_TILE_LENGTHS = (0, 1, 64, 65, 128, 129)


@pytest.mark.parametrize("case", ["mask", "bias", "dropout", "causal"])
def test_flash_fwd_padded_key_tiles(case):
    """The semantics the forward kernel's padded-key-tile skip relies on
    (its bf16 body neither loads nor computes a 64-key tile that holds no
    valid key): the port's plain version matches the JAX Pallas forward
    at rows ending on each side of a tile's edge, a fully padded row gives
    zeros, and neither side's out or lse moves when K and V at padded keys
    are replaced by other seeded values."""
    t, b = 256, len(PADDED_TILE_LENGTHS)
    rng = np.random.default_rng(13)
    q, k, v = (rng.normal(size=(b, t, H, D)).astype(np.float32)
               for _ in range(3))
    mask = (np.arange(t)[None] < np.array(PADDED_TILE_LENGTHS)[:, None]
            ).astype(np.int32)
    jkw, tkw = dict(kv_mask=jnp.asarray(mask)), dict(
        kv_mask=torch.from_numpy(mask))
    if case == "bias":
        bias = rng.normal(size=(b, 1, t, t)).astype(np.float32)
        jkw["bias"], tkw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    elif case == "dropout":
        jkw.update(dropout_rate=0.1, dropout_seed=np.int32(77),
                   dropout_pos=(3, 5))
        tkw.update(dropout=0.1, seed3=torch.tensor([77, 3, 5],
                                                   dtype=torch.int32))
    elif case == "causal":
        jkw["causal"] = tkw["causal"] = True

    def both(kk, vv):
        jo, jl = jax_flash(*(jnp.asarray(a) for a in (q, kk, vv)),
                           block_q=64, block_k=128, interpret=True,
                           return_lse=True, **jkw)
        to, tl = flash_fwd_reference(*(torch.from_numpy(a)
                                       for a in (q, kk, vv)), **tkw)
        jl = np.asarray(jl).transpose(0, 2, 1).reshape(b * H, t)
        return (np.asarray(jo), jl), (to.numpy(), tl.numpy())

    pair = both(k, v)
    _close(pair)
    (jo, _), (to, _) = pair
    assert np.all(to[0] == 0) and np.all(jo[0] == 0)
    padded = mask == 0
    k2, v2 = k.copy(), v.copy()
    k2[padded] = 10 * rng.normal(size=(padded.sum(), H, D))
    v2[padded] = 10 * rng.normal(size=(padded.sum(), H, D))
    for got, want in zip(both(k2, v2), pair):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_hash_bits_bit_exact():
    rng = np.random.default_rng(8)
    seed, bh, qp, kp = (rng.integers(-2 ** 31, 2 ** 31, size=4096,
                                     dtype=np.int64).astype(np.int32)
                        for _ in range(4))
    want = np.asarray(jax_hash_bits(*(jnp.asarray(a)
                                      for a in (seed, bh, qp, kp))))
    got = _hash_bits(*(torch.from_numpy(a) for a in (seed, bh, qp, kp)))
    # negative coordinates and seeds, where an arithmetic shift differs
    # from a logical one
    assert got.dtype == torch.int32 and (seed < 0).any() and (qp < 0).any()
    np.testing.assert_array_equal(got.numpy(), want)
    for rate in (0.1, 0.5):
        np.testing.assert_array_equal(
            drop_keep_mask(*(torch.from_numpy(a)
                             for a in (seed, bh, qp, kp)), rate).numpy(),
            np.asarray(jax_drop_keep_mask(*(jnp.asarray(a) for a in (
                seed, bh, qp, kp)), rate)))


def test_argument_checks_and_cpu_kernel_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(16))
    with pytest.raises(ValueError, match="kv_mask shape"):
        flash_attention(q, k, v, kv_mask=torch.ones(16, B))
    with pytest.raises(ValueError, match="bias shape"):
        flash_attention(q, k, v, bias=torch.zeros(B, 3, 16, 16))
    with pytest.raises(ValueError, match="needs dropout_seed"):
        flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="not in"):
        flash_attention(q, k, v, dropout_rate=1.0)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        flash_attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        flash_fwd(q, k, v)
    gen = torch.Generator().manual_seed(0)
    a = flash_attention(q, k, v, dropout_rate=0.5, dropout_generator=gen)
    gen.manual_seed(0)
    b = flash_attention(q, k, v, dropout_rate=0.5, dropout_generator=gen)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_checks_take_bh_past_65535():
    """The kernels' grids are 1-D, so their argument checks take b*h =
    65544 (BERT's 12 heads at batch 5462), which a grid.y of b*h refused,
    and refuse only b*h*t past 2^31 - 1 (lse rows indexed in 32 bits).
    Checked on CPU tensors: the checks run without a card."""
    b, t, h, d = 5462, 1, 12, 32
    q, k, v = (torch.empty(b, t, h, d, dtype=torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(b, t, dtype=torch.int32)
    bias = torch.zeros(b, 1, t, t)
    assert check_args(q, k, v, mask, bias) == 3
    assert check_args(q, k, v) == 0
    # b*h*t = 2^31: views with a zero batch stride, nothing allocated
    big = torch.empty(1, 2 ** 16, h, d).expand(2 ** 31 // (2 ** 16 * h) + 1,
                                               2 ** 16, h, d)
    with pytest.raises(ValueError, match="2\\^31"):
        check_args(big, big, big)


@pytest.mark.parametrize("shape", ["1xh", "bx1", "bxh", "1x1"])
def test_bias_split_past_65535_planes(shape):
    """`bias_split` at b*h = 65544: each collapsed bias plane's replicas
    are exactly the bh indices the forward reads that plane at (its
    bias_mode projection), every bh once."""
    b, h = 5462, 12
    lead_shape = {"1xh": (1, h), "bx1": (b, 1), "bxh": (b, h),
                  "1x1": (1, 1)}[shape]
    lead, reps, mul_l, mul_r = bias_split((*lead_shape, 4, 4), b, h)
    assert lead == lead_shape[0] * lead_shape[1]
    bh = (mul_l * np.arange(lead)[:, None]
          + mul_r * np.arange(reps)[None, :])
    assert sorted(bh.ravel().tolist()) == list(range(b * h))
    mode = _bias_mode(torch.empty(*lead_shape, 0, 0), b, h)
    plane = {1: bh, 2: bh % h, 3: bh // h, 4: 0 * bh}[mode]
    np.testing.assert_array_equal(plane, np.arange(lead)[:, None]
                                  + 0 * bh)
