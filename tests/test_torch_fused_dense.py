"""The port's fused dense + bias + GELU (analytics_zoo_tpu_torch/ops/
dense.py and ops/kernels/fused_dense.py) held against the JAX package on
the same numpy inputs: its Pallas kernel in interpret mode and its XLA
path.  On the CPU the port runs its plain version; the CUDA kernel is
held against that plain version on the card by chip_smoke.py.

Tolerances: f32 1e-5 absolute (the same f32 arithmetic, summed in
another order).  bf16 against the Pallas kernel: one bf16 ulp, 2^-7
relative at most (both accumulate in f32 and cast once; only a value on
a rounding boundary may land one ulp apart).  bf16 against the XLA
path, which rounds the product, the bias add and each GELU step to
bf16: 0.03 absolute plus 2^-6 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops.dense import DenseGelu as JaxDenseGelu
from analytics_zoo_tpu.ops.dense import dense_bias_gelu as jax_dense_gelu
from analytics_zoo_tpu.ops.pallas.fused_dense import dense_bias_gelu_pallas
from analytics_zoo_tpu_torch.ops import kernels
from analytics_zoo_tpu_torch.ops.dense import DenseGelu, dense_bias_gelu
from analytics_zoo_tpu_torch.ops.kernels import fused_dense as fd
from analytics_zoo_tpu_torch.ops.kernels.fused_dense import (
    dense_bias_gelu_reference,
    fused_dense_gelu,
)

F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7
XLA_ATOL, XLA_RTOL = 0.03, 2.0 ** -6
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    b = (0.5 * rng.normal(size=n)).astype(np.float32)
    return x, w, b


def _port(x, w, b, tdtype, **kw):
    """The port on flax-layout numpy inputs (w [k, n] -> weight [n, k]),
    rounded to `tdtype` first, returned as f32 numpy."""
    tx, tw, tb = (torch.from_numpy(np.ascontiguousarray(a)).to(tdtype)
                  for a in (x, w.T, b))
    return dense_bias_gelu(tx, tw, tb, **kw).float().numpy()


def _jax_in(x, w, b, jdtype):
    return tuple(jnp.asarray(a).astype(jdtype) for a in (x, w, b))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(16, 128, 256), (64, 256, 128)])
def test_plain_matches_pallas_kernel(dtype, m, k, n):
    _, jdtype, tdtype = DTYPES[dtype]
    x, w, b = _inputs(m, k, n, seed=m + n)
    want = np.asarray(dense_bias_gelu_pallas(
        *_jax_in(x, w, b, jdtype), block_m=8, block_n=128, block_k=128,
        interpret=True).astype(jnp.float32))
    got = _port(x, w, b, tdtype)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=BF16_ULP)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_xla_path(dtype):
    _, jdtype, tdtype = DTYPES[dtype]
    x, w, b = _inputs(24, 96, 80, seed=5)       # shapes no tile divides
    want = np.asarray(jax_dense_gelu(*_jax_in(x, w, b, jdtype),
                                     impl="xla").astype(jnp.float32))
    got = _port(x, w, b, tdtype)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=XLA_ATOL, rtol=XLA_RTOL)


def test_leading_axes():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 5, 32)).astype(np.float32)
    _, w, b = _inputs(1, 32, 48, seed=4)
    want = np.asarray(jax_dense_gelu(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), impl="xla"))
    got = _port(x, w, b, torch.float32)
    assert got.shape == (2, 3, 5, 48)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    flat = dense_bias_gelu_reference(
        torch.from_numpy(x.reshape(-1, 32)), torch.from_numpy(w.T.copy()),
        torch.from_numpy(b))
    np.testing.assert_array_equal(flat.numpy().reshape(2, 3, 5, 48), got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_gelu_module_through_converted_weights(dtype):
    """The JAX module's "kernel"/"bias" params, transposed into the
    port's weight/bias, give the same outputs, with nn.Dense's dtype
    promotion (f32 input and params cast to bf16)."""
    _, jdtype, tdtype = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 7, 40)).astype(np.float32)
    jm = JaxDenseGelu(56, dtype=jdtype, impl="xla")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": jnp.asarray(0.1 * rng.normal(size=56), jnp.float32)}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x))
                      .astype(jnp.float32))
    tm = DenseGelu(40, 56, dtype=tdtype, device="cpu")
    tm.load_state_dict({
        "weight": torch.from_numpy(np.asarray(params["kernel"]).T.copy()),
        "bias": torch.from_numpy(np.array(params["bias"]))})
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.dtype == tdtype and tuple(out.shape) == (3, 7, 56)
    if dtype == "f32":
        np.testing.assert_allclose(out.numpy(), want, atol=F32_TOL, rtol=0)
    else:
        np.testing.assert_allclose(out.float().numpy(), want,
                                   atol=XLA_ATOL, rtol=XLA_RTOL)


def test_cpu_tensor_with_kernel_impl_raises():
    x, w, b = (torch.from_numpy(a) for a in _inputs(4, 8, 16))
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        dense_bias_gelu(x, w.t().contiguous(), b, impl="kernel")
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        fused_dense_gelu(x, w.t().contiguous(), b)
    with pytest.raises(ValueError, match="unknown dense_bias_gelu impl"):
        dense_bias_gelu(x, w.t().contiguous(), b, impl="pallas")


class _OnCard(torch.Tensor):
    """A CPU tensor that passes the wrapper's device check, so its
    argument checks, routing and counting run without a card."""

    @property
    def is_cuda(self):
        return True


def _operands(m, k, n, dtype, offset=0):
    """x [m, k] (starting `offset` elements into its buffer), weight
    [n, k], bias [n] as `_OnCard` tensors."""
    buf = torch.zeros(m * k + offset, dtype=dtype)
    x = buf[offset:].view(m, k)
    return tuple(a.as_subclass(_OnCard) for a in (
        x, torch.zeros(n, k, dtype=dtype), torch.zeros(n, dtype=dtype)))


@pytest.mark.parametrize("m,k,n,dtype,offset,want", [
    (16384, 768, 3072, torch.bfloat16, 0, "sm90"),    # BERT fc1
    (1000, 768, 1000, torch.bfloat16, 0, "sm90"),     # ragged m and n
    (1000, 770, 1000, torch.bfloat16, 0, "cp_async"),  # k % 8 != 0
    (1000, 768, 1001, torch.bfloat16, 0, "cp_async"),  # n % 8 != 0
    (64, 768, 128, torch.bfloat16, 1, "cp_async"),    # base not 16-aligned
    (64, 768, 128, torch.float32, 0, "f32"),
])
def test_wrapper_routes_and_counts_each_body(monkeypatch, m, k, n, dtype,
                                             offset, want):
    """The wrapper sends bf16 operands TMA can read and write to the sm90
    body and the rest to cp_async (f32 to its own body), passes the body's number
    to the C entry point, counts the launch in the total and under its
    body, and raises, naming the body, on a failed launch."""
    calls = []

    def fake_launch(name, x, weight, bias, out):
        calls.append((name, fd.BODIES[name], tuple(x.shape), tuple(out.shape)))
        return 0

    monkeypatch.setattr(fd, "_launch", fake_launch)
    kernels.reset_launch_counts()
    assert fused_dense_gelu.launches_by_body == {"f32": 0, "cp_async": 0,
                                                 "sm90": 0}
    x, w, b = _operands(m, k, n, dtype, offset)
    assert fd.body(x, w) == want
    out = fused_dense_gelu(x, w, b)
    assert tuple(out.shape) == (m, n) and out.dtype == dtype
    fused_dense_gelu(x, w, b)
    assert calls == [(want, fd.BODIES[want], (m, k), (m, n))] * 2
    assert fused_dense_gelu.launches == 2
    assert fused_dense_gelu.launches_by_body == {
        name: 2 if name == want else 0 for name in fd.BODIES}
    kernels.reset_launch_counts()
    assert fused_dense_gelu.launches == 0
    assert set(fused_dense_gelu.launches_by_body.values()) == {0}
    monkeypatch.setattr(fd, "_launch", lambda *a: 98)
    with pytest.raises(RuntimeError, match=f"{want} body.*error 98"):
        fused_dense_gelu(x, w, b)
    assert fused_dense_gelu.launches == 0
