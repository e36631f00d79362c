"""The port's LayerNorm (analytics_zoo_tpu_torch/ops/normalization.py and
its kernel module) held against the JAX package's LayerNorm: the Pallas
forward kernel in interpret mode and the XLA path, on the same numpy
inputs.  On the CPU the port runs its plain version; the Triton kernel
itself is held against that plain version on the card by
chip_smoke.py.  Tolerance 1e-5 absolute: the same f32 formula, summed
in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from analytics_zoo_tpu.ops.normalization import layer_norm as jax_layer_norm
from analytics_zoo_tpu.ops.pallas.layer_norm import _ln_fwd
from analytics_zoo_tpu_torch.ops.kernels.layer_norm import (
    layer_norm_fwd,
    layer_norm_fwd_reference,
)
from analytics_zoo_tpu_torch.ops.normalization import LayerNorm, layer_norm

TOL = 1e-5


def _inputs(rows, d, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, d)) * 3 + 1.5).astype(np.float32)
    scale = (1 + 0.2 * rng.normal(size=d)).astype(np.float32)
    bias = (0.3 * rng.normal(size=d)).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, **kw):
    return layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                      torch.from_numpy(bias), **kw).numpy()


@pytest.mark.parametrize("rows", [8, 24, 1])
@pytest.mark.parametrize("d", [128, 96])
def test_matches_jax_xla_path(rows, d):
    x, scale, bias = _inputs(rows, d, seed=rows + d)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias), impl="xla"))
    np.testing.assert_allclose(_port(x, scale, bias), want, atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("rows", [8, 24])
@pytest.mark.parametrize("d", [128, 96])
def test_matches_jax_pallas_kernel_outputs(rows, d):
    """y, mean and rstd against the Pallas forward kernel run in
    interpret mode.  (rows=1 cannot run there: the Pallas kernel needs
    rows to tile a row block of at least 8; the XLA test covers it.)"""
    x, scale, bias = _inputs(rows, d, seed=3 * rows + d)
    y, mean, rstd = _ln_fwd(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias), eps=1e-6, block_rows=8,
                            out_dtype=jnp.float32, interpret=True)
    got_y, got_mean, got_rstd = layer_norm_fwd_reference(
        torch.from_numpy(x), torch.from_numpy(scale),
        torch.from_numpy(bias), 1e-6)
    for got, want in ((got_y, y), (got_mean, mean), (got_rstd, rstd)):
        assert tuple(got.shape) == tuple(want.shape)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=0)
    via_dispatch = np.asarray(jax_layer_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        impl="pallas", interpret=True, block_rows=8))
    np.testing.assert_allclose(_port(x, scale, bias), via_dispatch,
                               atol=TOL, rtol=0)


def test_leading_axes_and_module():
    """[..., d] inputs keep their shape; the module's params are the
    JAX module's scale/bias under PyTorch names, eps 1e-6."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 96)).astype(np.float32)
    ln = LayerNorm(96, device="cpu")
    assert ln.eps == 1e-6
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(
            (1 + 0.1 * rng.normal(size=96)).astype(np.float32)))
        ln.bias.uniform_(-0.5, 0.5)
        got = ln(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_layer_norm(
        jnp.asarray(x), jnp.asarray(ln.weight.detach().numpy()),
        jnp.asarray(ln.bias.detach().numpy()), impl="xla"))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_constant_rows_clip_variance_at_zero():
    """The fast variance E[x^2] - E[x]^2 can come out negative for a
    constant row; it is clipped at 0 as in the JAX formula, so the
    output is finite.  (Both sides then scale the rounding error of
    the mean by rsqrt(eps) = 1000, in different reduction orders, so
    they agree only to that error's size, not to 1e-5.)"""
    x = np.full((8, 128), 3.7, np.float32)
    scale = np.ones(128, np.float32)
    bias = np.zeros(128, np.float32)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias), impl="xla"))
    got = _port(x, scale, bias)
    mean_ulp = float(np.spacing(np.float32(3.7)))
    for y in (got, want):
        assert np.isfinite(y).all()
        assert np.abs(y).max() <= 4 * mean_ulp * 1e3


def test_bf16_input_promotes_like_jax():
    x, scale, bias = _inputs(8, 128, seed=11)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layer_norm(xb, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.float32
    want = np.asarray(jax_layer_norm(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale),
        jnp.asarray(bias), impl="xla"))
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_dispatch_never_falls_back():
    """A CPU tensor asked to take the kernel raises (the kernel runs on
    the card only); an unknown impl raises."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(8, 128))
    with pytest.raises(ValueError, match="Triton kernel"):
        layer_norm(x, scale, bias, impl="kernel")
    with pytest.raises(ValueError, match="Triton kernel"):
        layer_norm_fwd(x, scale, bias)
    with pytest.raises(ValueError, match="unknown layer_norm impl"):
        layer_norm(x, scale, bias, impl="pallas")
    assert layer_norm_fwd.launches == 0
