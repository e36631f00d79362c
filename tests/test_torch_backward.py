"""The port's backward passes held against the JAX package's, on the same
numpy inputs and cotangents: LayerNorm (`ops.normalization.layer_norm`,
plain version of K1b) against `jax.vjp` of the Pallas LayerNorm, the
fused dense + GELU (`ops.dense.dense_bias_gelu`) against `jax.grad`
through the Pallas kernel's custom_vjp, and flash attention
(`ops.attention.flash_attention`, plain versions of K4a, K4b and K5)
against `jax.grad` through the JAX `flash_attention`.  The Pallas
kernels run in interpret mode with explicit block sizes, so their own
backward kernels run (with a kv_mask the backward block_k is a multiple
of 128 or t), never the JAX wrapper's reference fallback.  On the CPU the
port runs the same autograd Functions as on the card, with the plain
versions the card's kernels are held against by chip_smoke.py.

Tolerances, each with its reason:
  * f32 1e-5 absolute on LayerNorm and dense + GELU gradients and 2e-5
    on flash gradients of magnitude up to ~10: the same f32 arithmetic
    summed in other orders (flash sums t = 128 terms per element);
  * bf16 LayerNorm dx: one bf16 ulp (2^-7 of |ref|) + 1e-6, both sides
    computing in f32 from the same bf16 x and rounding once; dscale and
    dbias stay f32 (1e-5);
  * bf16 dense + GELU: 2^-6 of the largest |gradient| element, since
    JAX rounds the recomputed pre-activation's GELU derivative in bf16
    where the port takes it in f32 before rounding the product;
  * bf16 flash: 2e-2 absolute, the forward test's bound, since both sides
    round p~ and ds to bf16 before the products but from f32 values
    computed in other orders;
  * dropout keep masks are the same bits: at rate 0.1 a single flipped
    bit would move a gradient by ~1e-2, two orders above the f32 gate."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash,
)
from analytics_zoo_tpu.ops.pallas.fused_dense import dense_bias_gelu_pallas
from analytics_zoo_tpu.ops.pallas.layer_norm import layer_norm_pallas
from analytics_zoo_tpu_torch.ops.attention import flash_attention
from analytics_zoo_tpu_torch.ops.dense import dense_bias_gelu
from analytics_zoo_tpu_torch.ops.kernels.flash_attention import (
    flash_bwd_dbias,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from analytics_zoo_tpu_torch.ops.kernels.layer_norm import layer_norm_bwd
from analytics_zoo_tpu_torch.ops.normalization import layer_norm

TOL, FLASH_TOL, BF16_FLASH_TOL = 1e-5, 2e-5, 2e-2
B, H, D, T = 2, 2, 32, 128


def _leaf(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype).requires_grad_(True)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------- K1b

@pytest.mark.parametrize("rows", [64, 100])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_layer_norm_grads_match_pallas(rows, x_dtype):
    """rows 64 tile the 32-row block; rows 100 do not (the JAX wrapper
    shrinks its block to 4 rows, the port's kernel masks a ragged
    block)."""
    d = 96
    rng = np.random.default_rng(rows)
    x = (rng.normal(size=(rows, d)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.2 * rng.normal(size=d)).astype(np.float32)
    bias = (0.3 * rng.normal(size=d)).astype(np.float32)
    g = rng.normal(size=(rows, d)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(x_dtype))
    y, vjp = jax.vjp(lambda a, s, b: layer_norm_pallas(
        a, s, b, block_rows=32, interpret=True), jx, jnp.asarray(scale),
        jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(g).astype(y.dtype))
    tx = _leaf(jx.astype(jnp.float32), getattr(torch, x_dtype))
    ts, tb = _leaf(scale), _leaf(bias)
    out = layer_norm(tx, ts, tb)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(g))
    assert tx.grad.dtype == tx.dtype and ts.grad.dtype == torch.float32
    want = _np(jdx)
    tol = TOL if x_dtype == "float32" else 2.0 ** -7 * np.abs(want) + 1e-6
    assert np.all(np.abs(tx.grad.float().numpy() - want) <= tol)
    np.testing.assert_allclose(ts.grad.numpy(), _np(jds), atol=TOL, rtol=0)
    np.testing.assert_allclose(tb.grad.numpy(), _np(jdb), atol=TOL, rtol=0)


def test_layer_norm_bwd_kernel_raises_on_cpu():
    x = torch.zeros(8, 16)
    stat = torch.zeros(8, 1)
    with pytest.raises(ValueError, match="launches a Triton kernel"):
        layer_norm_bwd(x, torch.ones(16), stat, stat, x)
    with pytest.raises(ValueError, match="launches a Triton kernel"):
        layer_norm(x.requires_grad_(True), torch.ones(16), torch.zeros(16),
                   impl="kernel")


# ---------------------------------------------------------------- K2 bwd

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_gelu_grads_match_pallas_custom_vjp(dtype):
    m, k, n = 64, 32, 48
    rng = np.random.default_rng(7)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    b = (0.3 * rng.normal(size=n)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    jd = jnp.dtype(dtype)
    jx, jw, jb = (jnp.asarray(a).astype(jd) for a in (x, w, b))

    def loss(a, ww, bb):
        y = dense_bias_gelu_pallas(a, ww, bb, block_m=32, block_n=16,
                                   block_k=32, interpret=True)
        return (y.astype(jnp.float32) * jnp.asarray(g)).sum()

    jdx, jdw, jdb = jax.grad(loss, argnums=(0, 1, 2))(jx, jw, jb)
    td = getattr(torch, dtype)
    tx = _leaf(jx.astype(jnp.float32), td)
    tw = _leaf(jw.astype(jnp.float32).T, td)       # Linear layout [n, k]
    tb = _leaf(jb.astype(jnp.float32), td)
    y = dense_bias_gelu(tx, tw, tb)
    (y.float() * torch.from_numpy(g)).sum().backward()
    for got, want in ((tx.grad, jdx), (tw.grad.t(), jdw), (tb.grad, jdb)):
        assert got.dtype == td
        want = _np(want)
        tol = TOL if dtype == "float32" else 2.0 ** -6 * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=0)


# ---------------------------------------------------------------- flash

def _qkv(seed, t=T):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, t, H, D)).astype(np.float32)
                 for _ in range(3))


def _flash_grads(q, k, v, *, bias=None, lse_loss=False, jdtype=jnp.float32,
                 tdtype=torch.float32, fused=False, blocks=(64, 128), **kw):
    """(JAX grads, port grads) of sum(out * go) [+ sum(lse * gl)] with
    respect to q, k, v [and the bias], as f32 numpy; `kw` numpy arrays
    or plain values handed to both."""
    b, t = q.shape[:2]
    rng = np.random.default_rng(99)
    go = rng.normal(size=q.shape).astype(np.float32)
    gl = rng.normal(size=(b, t, H)).astype(np.float32)
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    bq, bk = blocks

    def loss(qq, kk, vv, bb):
        out, lse = jax_flash(qq, kk, vv, bias=bb, block_q=bq, block_k=bk,
                             bwd_block_q=bq, bwd_block_k=bk, interpret=True,
                             return_lse=True, **jkw)
        val = (out.astype(jnp.float32) * go).sum()
        return val + (lse * gl).sum() if lse_loss else val

    jargs = [jnp.asarray(a).astype(jdtype) for a in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias)
    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    jg = jax.grad(loss, argnums=argnums)(*jargs, jb)
    tq, tk, tv = (_leaf(np.asarray(a.astype(jnp.float32)), tdtype)
                  for a in jargs)
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    if fused:
        qkv = torch.cat([a.detach().reshape(b, t, H * D)
                         for a in (tq, tk, tv)], -1).requires_grad_(True)
        ins = tuple(a.reshape(b, t, H, D) for a in qkv.split(H * D, -1))
    else:
        ins = (tq, tk, tv)
    out, lse = flash_attention(*ins, bias=tb, return_lse=True, **tkw)
    val = (out.float() * torch.from_numpy(go)).sum()
    if lse_loss:
        val = val + (lse * torch.from_numpy(gl)).sum()
    val.backward()
    if fused:
        tg = [g.reshape(b, t, H, D) for g in qkv.grad.split(H * D, -1)]
    else:
        tg = [tq.grad, tk.grad, tv.grad]
    if tb is not None:
        assert tb.grad.shape == tb.shape and tb.grad.dtype == tb.dtype
        tg.append(tb.grad)
    assert all(g.dtype == tdtype for g in tg[:3])
    return [_np(g) for g in jg], [g.float().numpy() for g in tg]


def _close(pair, tol=FLASH_TOL):
    for want, got in zip(*pair):
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_flash_grads_kv_mask_fully_padded_row():
    q, k, v = _qkv(1)
    mask = np.ones((B, T), np.int32)
    mask[0, 77:] = 0
    mask[1, :] = 0                      # every key of batch 1 is padding
    pair = _flash_grads(q, k, v, kv_mask=mask)
    _close(pair)
    for g in pair[1]:
        assert np.all(g[1] == 0)        # exactly zero, as JAX's


def test_flash_grads_causal_and_lse_loss():
    q, k, v = _qkv(2)
    mask = np.ones((B, T), np.int32)
    mask[1, 90:] = 0
    _close(_flash_grads(q, k, v, kv_mask=mask, causal=True, lse_loss=True))


def test_flash_grads_dropout_masks_bit_identical():
    q, k, v = _qkv(3)
    mask = np.ones((B, T), np.int32)
    mask[0, 100:] = 0
    kw = dict(kv_mask=mask, dropout_rate=0.1, dropout_pos=(3, 7))
    pair = _flash_grads(q, k, v, dropout_seed=np.int32(4321), **kw)
    _close(pair)
    # another seed drops other probabilities: the gradients move by far
    # more than the gate
    _, other = _flash_grads(q, k, v, dropout_seed=np.int32(4322), **kw)
    assert max(np.abs(o - w).max() for o, w in zip(other, pair[0])) > 1e-2


def test_flash_grads_bf16():
    q, k, v = _qkv(4)
    mask = np.ones((B, T), np.int32)
    mask[0, 64:] = 0
    _close(_flash_grads(q, k, v, kv_mask=mask, jdtype=jnp.bfloat16,
                        tdtype=torch.bfloat16), BF16_FLASH_TOL)


def test_flash_grads_through_fused_qkv():
    """q, k, v as strided views of one [b, t, 3*h*d] projection, as
    MultiHeadAttention slices them: d(qkv) is the three gradients side
    by side."""
    q, k, v = _qkv(5)
    mask = np.ones((B, T), np.int32)
    mask[1, 30:] = 0
    _close(_flash_grads(q, k, v, kv_mask=mask, fused=True))


@pytest.mark.parametrize("lead", [(1, 1), (1, H), (B, 1), (B, H)])
def test_flash_dbias_each_broadcast(lead):
    q, k, v = _qkv(6)
    bias = np.random.default_rng(7).normal(size=(*lead, T, T)).astype(
        np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 50:] = 0
    _close(_flash_grads(q, k, v, bias=bias, kv_mask=mask,
                        dropout_rate=0.1, dropout_seed=np.int32(11)))


@pytest.mark.parametrize("case", ["mask", "dropout", "bias", "causal"])
def test_flash_grads_padded_key_tiles_exactly_zero(case):
    """The invariant K4b's padded-key-tile skip relies on: at a key the
    kv_mask pads, p = 0, so ds = p~ = 0 and dk, dv are exactly 0 there
    (a 128-key block of padding writes zeros without computing).  Batch
    row 0 has a whole trailing 128-key tile of padding; row 1's last
    valid key, 128, is the first key of its tile.  Both the JAX Pallas
    backward and the port's plain version give exact zeros at every
    padded key, and agree elsewhere."""
    t = 256
    q, k, v = _qkv(9, t=t)
    mask = np.ones((B, t), np.int32)
    mask[0, 128:] = 0
    mask[1, 129:] = 0
    kw = dict(kv_mask=mask)
    if case == "dropout":
        kw.update(dropout_rate=0.1, dropout_seed=np.int32(5))
    elif case == "bias":
        kw["bias"] = np.random.default_rng(10).normal(
            size=(B, 1, t, t)).astype(np.float32)
    elif case == "causal":
        kw["causal"] = True
    pair = _flash_grads(q, k, v, **kw)
    _close(pair)
    padded = mask == 0
    for grads in pair:
        _, dk, dv = grads[:3]
        assert np.all(dk[padded] == 0) and np.all(dv[padded] == 0)
        assert np.abs(dk[~padded]).max() > 0 and np.abs(dv[~padded]).max() > 0


@pytest.mark.parametrize("case", ["mask", "bias", "dropout", "causal"])
def test_flash_dq_padded_key_tiles(case):
    """The invariant the dQ kernel's padded-key-tile skip relies on (its
    bf16 body neither loads nor computes a 64-key tile that holds no
    valid key): ds = 0 at a padded key, so dq does not move, bit for bit,
    on either side when K and V at padded keys are replaced by other
    seeded values; and the port's plain version matches JAX's Pallas
    backward at rows ending on each side of a tile's edge (valid lengths
    0, 1, 64, 65, 128, 129)."""
    t = 256
    lengths = np.array([0, 1, 64, 65, 128, 129])
    b = len(lengths)
    rng = np.random.default_rng(14)
    q, k, v = (rng.normal(size=(b, t, H, D)).astype(np.float32)
               for _ in range(3))
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.int32)
    kw = dict(kv_mask=mask)
    if case == "dropout":
        kw.update(dropout_rate=0.1, dropout_seed=np.int32(6))
    elif case == "bias":
        kw["bias"] = rng.normal(size=(b, 1, t, t)).astype(np.float32)
    elif case == "causal":
        kw["causal"] = True
    pair = _flash_grads(q, k, v, **kw)
    np.testing.assert_allclose(pair[1][0], pair[0][0], atol=FLASH_TOL,
                               rtol=0)
    assert np.all(pair[1][0][0] == 0) and np.all(pair[0][0][0] == 0)
    padded = mask == 0
    k2, v2 = k.copy(), v.copy()
    k2[padded] = 10 * rng.normal(size=(padded.sum(), H, D))
    v2[padded] = 10 * rng.normal(size=(padded.sum(), H, D))
    for got, want in zip(_flash_grads(q, k2, v2, **kw), pair):
        np.testing.assert_array_equal(got[0], want[0])


def test_flash_bwd_kernels_raise_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, t=16))
    lse = torch.zeros(B * H, 16)
    args = (q, k, v, q, lse, lse)
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError, match="launches a CUDA kernel"):
            fn(*args)
    with pytest.raises(ValueError, match="needs the bias"):
        flash_bwd_dbias(*args)


@pytest.mark.parametrize("lead", [(B, 1), (1, H), (B, H), (1, 1)])
def test_flash_dbias_padded_key_tiles_exactly_zero(lead):
    """The invariant K5's padded-key-tile skip relies on (its bf16 body
    neither loads nor computes a replica's 64-key tile that holds no
    valid key): ds = 0 at a padded key, so a replica adds exactly 0 to
    the bias's gradient there.  Batch row 0 pads a whole trailing
    128-key tile, row 1 everything past its first key of that tile; at a
    key every summed replica pads, dbias is exactly 0 on both sides."""
    t = 256
    q, k, v = _qkv(11, t=t)
    mask = np.ones((B, t), np.int32)
    mask[0, 128:] = 0
    mask[1, 129:] = 0
    bias = np.random.default_rng(12).normal(size=(*lead, t, t)).astype(
        np.float32)
    pair = _flash_grads(q, k, v, bias=bias, kv_mask=mask)
    _close(pair)
    # keys each bias plane's replicas all pad: [B, ...] planes per batch
    # row, [1, ...] planes where every batch row pads
    pads = (mask == 0) if lead[0] == B else (mask == 0).all(0)[None]
    for grads in pair:
        db = grads[3]
        for i in range(db.shape[0]):
            assert np.all(db[i][..., pads[i]] == 0)
            assert np.abs(db[i][..., ~pads[i]]).max() > 0
