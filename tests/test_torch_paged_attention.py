"""The port's attention ops (analytics_zoo_tpu_torch/ops/attention.py)
and int8 KV quantization held against the JAX package's: paged decode
attention against the Pallas kernel in interpret mode and the XLA
fallback over ragged decode scenes (a lane with ctx 0, a partial first
block, mid-block lanes, a block-aligned full lane, garbage past every
ctx_len), block sizes 8 and 16, f32, f16, bf16 and int8 pools.  On the
CPU the port runs its plain version; the CUDA kernel is held against
that on the card by chip_smoke.py.  Tolerance 1e-5 absolute (f32 compute
on both sides; the f16 and bf16 scenes read the same rounded values on
both sides, the int8 scenes dequantize the same int8 values).  Also the
kernel wrapper's argument checks on CPU tensors, and a CPU generation
engine on an f16 pool against the JAX engine on one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from analytics_zoo_tpu.ops.attention import (
    dot_product_attention as jax_attention,
    paged_decode_attention as jax_paged,
)
from analytics_zoo_tpu.serving.generation.kv_cache import (
    quantize_kv_tokens as jax_quantize,
)
from analytics_zoo_tpu_torch.ops.attention import (
    dot_product_attention,
    paged_decode_attention,
)
from analytics_zoo_tpu_torch.ops.kernels.paged_attention import (
    MAX_CHUNK_TOKENS,
    UNIT_BYTES,
    body,
    check_args,
    paged_decode,
    plan,
)
from analytics_zoo_tpu_torch.serving.generation.kv_cache import (
    dequantize_kv_tokens,
    quantize_kv_tokens,
)

TOL = 1e-5
H, D = 4, 16


#: the pool dtypes of a scene: (torch dtype, jnp dtype)
_POOLS = {"f16": (torch.float16, jnp.float16),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _scene(bs, mb, s=5, seed=0, quantized=False, pool="f32"):
    """Lane 0: ctx 0 (null table, as a preempted lane); lane 1: a
    partial first block; the last lane block-aligned full; the rest
    mid-block.  Pool contents past each ctx_len are garbage.  An f16 or
    bf16 `pool` holds the f32 draws rounded to it (kept as f32 values,
    which both sides cast exactly)."""
    rng = np.random.default_rng(seed)
    nb = s * mb + 1
    kf = rng.normal(size=(nb, bs, H, D)).astype(np.float32)
    vf = rng.normal(size=(nb, bs, H, D)).astype(np.float32)
    tables = np.zeros((s, mb), np.int32)
    perm = 1 + rng.permutation(nb - 1)
    choices = [0, max(1, bs // 2)] + [
        int(rng.integers(1, mb * bs)) for _ in range(s - 3)] + [mb * bs]
    ctx = np.asarray(choices, np.int32)
    if pool in _POOLS:
        tdt = _POOLS[pool][0]
        kf, vf = (torch.from_numpy(a).to(tdt).float().numpy()
                  for a in (kf, vf))
    for i in range(s):
        used = -(-int(ctx[i]) // bs)
        tables[i, :used] = perm[i * mb:i * mb + used]
    sc = dict(q=rng.normal(size=(s, H, D)).astype(np.float32),
              new_k=rng.normal(size=(s, H, D)).astype(np.float32),
              new_v=rng.normal(size=(s, H, D)).astype(np.float32),
              k_pool=kf, v_pool=vf, tables=tables, ctx=ctx,
              k_scale=None, v_scale=None, pool=pool)
    if quantized:
        qk, sk = jax_quantize(jnp.asarray(kf))
        qv, sv = jax_quantize(jnp.asarray(vf))
        # np.array: writable copies, as torch.from_numpy wants
        sc.update(k_pool=np.array(qk), v_pool=np.array(qv),
                  k_scale=np.array(sk), v_scale=np.array(sv))
    return sc


def _jax(sc, impl):
    opt = (lambda a: None if a is None else jnp.asarray(a))
    dt = _POOLS[sc["pool"]][1] if sc["pool"] in _POOLS else None
    return np.asarray(jax_paged(
        jnp.asarray(sc["q"]), jnp.asarray(sc["new_k"]),
        jnp.asarray(sc["new_v"]), jnp.asarray(sc["k_pool"], dt),
        jnp.asarray(sc["v_pool"], dt), jnp.asarray(sc["tables"]),
        jnp.asarray(sc["ctx"]), k_scale=opt(sc["k_scale"]),
        v_scale=opt(sc["v_scale"]), impl=impl,
        interpret=(True if impl == "pallas" else None),
        block_gather=(1 if impl == "pallas" else None)))


def _pool(sc, key):
    t = torch.from_numpy(sc[key])
    return t.to(_POOLS[sc["pool"]][0]) if sc["pool"] in _POOLS else t


def _port(sc, **kw):
    opt = (lambda a: None if a is None else torch.from_numpy(a))
    return paged_decode_attention(
        torch.from_numpy(sc["q"]), torch.from_numpy(sc["new_k"]),
        torch.from_numpy(sc["new_v"]), _pool(sc, "k_pool"),
        _pool(sc, "v_pool"), torch.from_numpy(sc["tables"]),
        torch.from_numpy(sc["ctx"]), k_scale=opt(sc["k_scale"]),
        v_scale=opt(sc["v_scale"]), **kw).numpy()


@pytest.mark.parametrize("pool", ["f32", "int8", "f16", "bf16"])
@pytest.mark.parametrize("bs,mb", [(8, 4), (16, 3)])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_paged_decode_matches_jax(impl, bs, mb, pool):
    quantized = pool == "int8"
    sc = _scene(bs, mb, seed=bs + mb + quantized, quantized=quantized,
                pool=pool)
    got = _port(sc)
    assert got.shape == sc["q"].shape and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax(sc, impl), atol=TOL, rtol=0)


def test_empty_lane_returns_its_own_value():
    """ctx_len 0: the token attends only to itself, so the output is
    exactly new_v (the kernel's seed m = s_self, l = 1, o = new_v)."""
    sc = _scene(8, 4, seed=9)
    got = _port(sc)
    np.testing.assert_allclose(got[0], sc["new_v"][0], atol=1e-7, rtol=0)


def test_reference_impl_is_the_auto_path_on_cpu():
    sc = _scene(16, 3, seed=4, quantized=True)
    np.testing.assert_array_equal(_port(sc), _port(sc, impl="reference"))


def test_dispatch_never_falls_back():
    """A CPU tensor asked to take the kernel raises (the kernel runs on
    the card only), as does an unknown impl or a lone scale."""
    sc = _scene(8, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        _port(sc, impl="kernel")
    with pytest.raises(ValueError, match="unknown paged_decode_attention"):
        _port(sc, impl="pallas")
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA kernel"):
        paged_decode(t(sc["q"]), t(sc["new_k"]), t(sc["new_v"]),
                     t(sc["k_pool"]), t(sc["v_pool"]), t(sc["tables"]),
                     t(sc["ctx"]))
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged_decode_attention(
            t(sc["q"]), t(sc["new_k"]), t(sc["new_v"]), t(sc["k_pool"]),
            t(sc["v_pool"]), t(sc["tables"]), t(sc["ctx"]),
            k_scale=torch.ones(sc["k_pool"].shape[:2]))
    assert paged_decode.launches == 0


def test_quantize_kv_tokens_bitwise_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 7, H, D)) * 2).astype(np.float32)
    x[1, 2] = 0.0                       # all-zero slot: scale 1
    qj, sj = jax_quantize(jnp.asarray(x))
    qt, st = quantize_kv_tokens(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[1, 2]) == 1.0
    # the textbook round-trip bound |x - deq| <= scale / 2
    err = np.abs(dequantize_kv_tokens(qt, st).numpy() - x)
    assert (err <= st.numpy()[..., None, None] / 2 + 1e-7).all()


def test_full_attention_matches_jax():
    """Prefill path: causal plus an additive padding mask."""
    rng = np.random.default_rng(2)
    b, t = 2, 9
    q, k, v = (rng.normal(size=(b, t, H, D)).astype(np.float32)
               for _ in range(3))
    tm = np.ones((b, t), np.float32)
    tm[1, 6:] = 0
    mask = (1.0 - tm[:, None, None, :]) * -1e9
    want = np.asarray(jax_attention(q, k, v, mask=jnp.asarray(mask),
                                    causal=True,
                                    compute_dtype=jnp.float32))
    got = dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(mask), causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_ctx_read_path_matches_jax_and_full_recompute():
    """KV-cache read path with t > 1 new tokens over garbage-padded
    context, against JAX and against full causal attention."""
    rng = np.random.default_rng(3)
    b, t, h, d = 2, 9, 2, 8
    q, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32)
               for _ in range(3))
    c0, pad = 6, 4
    ctx_k = np.concatenate([k[:, :c0], rng.normal(size=(b, pad, h, d))],
                           1).astype(np.float32)
    ctx_v = np.concatenate([v[:, :c0], rng.normal(size=(b, pad, h, d))],
                           1).astype(np.float32)
    ctx_len = np.full(b, c0, np.int32)
    args = (q[:, c0:], k[:, c0:], v[:, c0:])
    want = np.asarray(jax_attention(
        *args, compute_dtype=jnp.float32, ctx_k=ctx_k, ctx_v=ctx_v,
        ctx_len=ctx_len))
    got = dot_product_attention(
        *(torch.from_numpy(a) for a in args),
        ctx_k=torch.from_numpy(ctx_k), ctx_v=torch.from_numpy(ctx_v),
        ctx_len=torch.from_numpy(ctx_len)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    full = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True).numpy()
    np.testing.assert_allclose(got, full[:, c0:], atol=TOL, rtol=0)


@pytest.mark.parametrize("pool", ["f32", "f16", "bf16", "int8"])
def test_kernel_checks_take_every_pool_dtype(pool):
    """The kernel wrapper's checks, on CPU tensors (no card): f32, f16
    and bf16 pools, and int8 with its scales; a float pool with scales,
    an int8 pool without, and another dtype are refused.  An aligned
    pool of at most 32 heads takes the split body, else rows."""
    s, h, d, nb, bs, mb = 3, 4, 32, 7, 8, 2
    dtype = {"f32": torch.float32, "f16": torch.float16,
             "bf16": torch.bfloat16, "int8": torch.int8}[pool]
    kp, vp = (torch.zeros(nb, bs, h, d, dtype=dtype) for _ in range(2))
    args = (*(torch.zeros(s, h, d) for _ in range(3)), kp, vp,
            torch.zeros(s, mb, dtype=torch.int32),
            torch.zeros(s, dtype=torch.int32))
    scales = (dict(k_scale=torch.ones(nb, bs), v_scale=torch.ones(nb, bs))
              if pool == "int8" else {})
    assert check_args(*args, **scales) == (pool == "int8")
    if pool == "int8":
        with pytest.raises(ValueError, match="int8 with k_scale"):
            check_args(*args)
    else:
        with pytest.raises(ValueError, match="int8 with k_scale"):
            check_args(*args, k_scale=torch.ones(kp.shape[:2]),
                       v_scale=torch.ones(kp.shape[:2]))
    with pytest.raises(ValueError, match="int8 with k_scale"):
        check_args(*args[:3], kp.double(), vp.double(), *args[5:])
    assert body(kp, vp) == "split"
    # a pool whose base is not 16-byte aligned: the rows body
    flat = torch.empty(kp.numel() + 1, dtype=kp.dtype)
    off = flat[1:].view(kp.shape)
    assert body(off, vp) == "rows"
    wide = torch.empty(2, 8, 33, d, dtype=kp.dtype)
    assert body(wide, wide) == "rows"


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("s,h,d,bs,mb", [(8, 12, 64, 16, 64),
                                         (1, 32, 256, 16, 4096),
                                         (64, 4, 32, 7, 9)])
def test_split_plan_covers_the_table(s, h, d, bs, mb, itemsize):
    """The split body's plan from the shapes alone: the chunks cover the
    table, a chunk holds at most MAX_CHUNK_TOKENS tokens, a unit lies in
    one pool block and holds about UNIT_BYTES of K and V (one token at
    least), and GPT-2 small's decode (8 lanes, 64-block tables) on 132
    SMs takes chunks of 4 pool blocks, 128 blocks."""
    cb, nc, unit = plan(s, h, d, bs, mb, itemsize, 132)
    assert nc * cb >= mb and (nc - 1) * cb < mb
    assert cb * bs <= max(bs, MAX_CHUNK_TOKENS)
    assert 1 <= unit <= bs
    assert unit == 1 or 2 * unit * h * d * itemsize <= UNIT_BYTES
    if (s, mb) == (8, 64):
        assert cb == 4 and nc * s == 128
