"""Ring attention and the distributed runtime in the port
(analytics_zoo_tpu_torch/parallel/, common/context.py) against the JAX
package's ring (parallel/ring_attention.py) on the CPU.

The port runs two gloo ranks, spawned once for the module
(`tests/_torch_ring_cases.py`, which imports no JAX) and fed every case
over a pipe; each rank holds the global arrays and returns the gathered
output and the gradients.  JAX runs `ring_self_attention` over an "sp"
mesh of 2 of its 8 virtual CPU devices (tests/conftest.py), every case's
value and `jax.grad` in one jitted program (one compile, not eight).

* forward and the gradients of q, k, v (and of the bias) equal JAX's
  ring for impl "einsum" and "flash", causal and not, with a kv_mask,
  and with dropout 0.2 and a learnable [1, h, t, t] bias, at atol 2e-5
  (JAX's own ring tests, tests/test_attention_parallel.py:47-52), the
  gradients at 1e-4 (the f32 sums of two shards' contributions in
  another order); both ranks return the same arrays;
* impl "auto" takes flash from `RING_FLASH_MIN_TLOCAL` positions a shard
  on (patched to the test's shard), einsum below, with equal outputs;
* without an "sp" axis `ring_self_attention` is one `flash_attention`;
* `MultiHeadAttention(attn_impl="ring")` equals JAX's layer on an "sp"
  mesh, its output and every gradient;
* the mesh: ranks, coordinates and groups, the gloo backend on the CPU,
  `shard_batch`'s slices and the sharding rules as JAX's specs."""

import importlib
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_ring_cases as cases
from _torch_chronos_cases import one_torch_thread  # noqa: F401
from analytics_zoo_tpu import init_orca_context as jax_init
from analytics_zoo_tpu import stop_orca_context as jax_stop
from analytics_zoo_tpu.keras.layers.self_attention import (
    MultiHeadAttention as JaxMHA,
)
from analytics_zoo_tpu.ops.pallas.flash_attention import fold_dropout_seed
from analytics_zoo_tpu.parallel import sharding as jax_sharding
from analytics_zoo_tpu.parallel.ring_attention import (
    ring_self_attention as jax_ring,
)
from analytics_zoo_tpu_torch.common.context import ProcessMesh
from analytics_zoo_tpu_torch.parallel import (
    data_parallelism,
    infer_param_shardings,
    logical_to_sharding,
    mesh_axis_size,
    shard_batch,
)

ra = importlib.import_module("analytics_zoo_tpu_torch.parallel.ring_attention")

ATOL = 2e-5
GRAD_ATOL = 1e-4
B, T, H, D = 2, 32, 2, 32
RATE = 0.2
KEY = jax.random.PRNGKey(3)
SEED = int(fold_dropout_seed(KEY)[0])

_rng = np.random.default_rng(0)
Q, K, V, W = (_rng.normal(size=(B, T, H, D)).astype(np.float32)
              for _ in range(4))
MASK = np.ones((B, T), np.int32)
MASK[:, T - 5:] = 0
BIAS = (0.5 * _rng.normal(size=(1, H, T, T))).astype(np.float32)

#: variant -> ring_self_attention keywords (the impl apart)
VARIANTS = {
    "plain": dict(causal=False),
    "causal": dict(causal=True),
    "kv_mask-causal": dict(causal=True, kv_mask=MASK),
    "dropout-bias": dict(causal=False, bias=BIAS, dropout_rate=RATE),
}
IMPLS = ("einsum", "flash")


@pytest.fixture(scope="module")
def ranks():
    """Two gloo ranks, as spawned interpreters, for the whole module."""
    ctx = mp.get_context("spawn")
    port = cases.free_port()
    pipes, procs = [], []
    for rank in range(cases.WORLD):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=cases.worker, args=(rank, port, child),
                        daemon=True)
        p.start()
        pipes.append(parent)
        procs.append(p)
    try:
        for pipe in pipes:
            assert pipe.poll(120), "a ring rank did not start"
            assert pipe.recv()[0] == "ready"

        def run(case):
            for pipe in pipes:
                pipe.send(case)
            out = []
            for pipe in pipes:
                assert pipe.poll(120), "a ring rank did not answer"
                status, res = pipe.recv()
                assert status == "ok", res
                out.append(res)
            return out

        yield run
        for pipe in pipes:
            pipe.send(None)
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def jax_refs():
    """Every variant's JAX output and gradients, from one program."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    w = jnp.asarray(W)

    def loss(impl, kw, q, k, v, bias):
        kw = dict(kw)
        if "bias" in kw:
            kw["bias"] = bias
        if kw.get("dropout_rate"):
            kw["dropout_rng"] = KEY
        if "kv_mask" in kw:
            kw["kv_mask"] = jnp.asarray(kw["kv_mask"])
        out = jax_ring(q, k, v, mesh=mesh, impl=impl, **kw)
        return (out * w).sum(), out

    def all_refs(q, k, v, bias):
        res = {}
        for impl in IMPLS:
            for name, kw in VARIANTS.items():
                (_, out), grads = jax.value_and_grad(
                    lambda *a: loss(impl, kw, *a), argnums=(0, 1, 2, 3),
                    has_aux=True)(q, k, v, bias)
                res[impl, name] = dict(out=out, dq=grads[0], dk=grads[1],
                                       dv=grads[2], dbias=grads[3])
        return res

    got = jax.jit(all_refs)(*(jnp.asarray(a) for a in (Q, K, V, BIAS)))
    return jax.tree_util.tree_map(np.asarray, got)


def _case(impl, kw, **extra):
    case = dict(runner="attention", q=Q, k=K, v=V, w=W, impl=impl, **kw,
                **extra)
    if kw.get("dropout_rate"):
        case["seed"] = SEED
    return case


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ring_matches_jaxs_ring(ranks, jax_refs, impl, variant):
    got = ranks(_case(impl, VARIANTS[variant]))
    want = jax_refs[impl, variant]
    for r in got:
        assert r["impl"] == impl
        np.testing.assert_allclose(r["out"], want["out"], atol=ATOL, rtol=0)
        for g in ("dq", "dk", "dv") + (("dbias",) if "dbias" in r else ()):
            np.testing.assert_allclose(r[g], want[g], atol=GRAD_ATOL,
                                       rtol=0, err_msg=g)
    for g in got[0]:
        if g != "impl":
            np.testing.assert_array_equal(got[0][g], got[1][g])
    if variant == "dropout-bias":
        # dropout dropped something: the no-dropout output differs
        assert not np.allclose(got[0]["out"],
                               jax_refs[impl, "plain"]["out"], atol=1e-3)


def test_auto_switches_at_the_shard_length(ranks, jax_refs):
    t_local = T // cases.WORLD
    flash = ranks(_case("auto", {}, min_tlocal=t_local))[0]
    einsum = ranks(_case("auto", {}, min_tlocal=t_local + 1))[0]
    assert (flash["impl"], einsum["impl"]) == ("flash", "einsum")
    assert ra.RING_FLASH_MIN_TLOCAL == 2048
    np.testing.assert_allclose(flash["out"], einsum["out"], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(flash["out"], jax_refs["einsum", "plain"][
        "out"], atol=ATOL, rtol=0)


def test_without_an_sp_axis_it_is_flash_attention(monkeypatch):
    calls = []
    real = ra.flash_attention

    def spy(*args, **kwargs):
        calls.append(kwargs.get("impl"))
        return real(*args, **kwargs)

    monkeypatch.setattr(ra, "flash_attention", spy)
    q, k, v = (torch.from_numpy(a) for a in (Q, K, V))
    out = ra.ring_self_attention(q, k, v, causal=True, impl="flash")
    assert calls == ["auto"]
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("dp",))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_ring(*(jnp.asarray(a) for a in (Q, K, V)),
                                         mesh=mesh, causal=True)),
        atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="impl must be"):
        ra.ring_self_attention(q, k, v, impl="xla")
    with pytest.raises(ValueError, match="process group on the 'sp'"):
        ra.ring_attention(q, k, v)


def test_keras_ring_layer_matches_jaxs(ranks):
    hid, heads = 64, 4
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, hid)).astype(np.float32)
    w = rng.normal(size=(B, T, hid)).astype(np.float32)
    layer = JaxMHA(hid, heads, causal=True, compute_dtype=jnp.float32,
                   attn_impl="ring")
    jax_stop()
    jax_init(cluster_mode="local", mesh_shape={"sp": 2})
    try:
        params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]

        def loss(p, x):
            out = layer.apply({"params": p}, x)
            return (out * w).sum(), out

        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    finally:
        jax_stop()
    state = {f"{n}.weight": np.asarray(params[n]["kernel"]).T.copy()
             for n in ("qkv", "proj")}
    state.update({f"{n}.bias": np.asarray(params[n]["bias"])
                  for n in ("qkv", "proj")})
    got = ranks(dict(runner="keras", hidden=hid, heads=heads, causal=True,
                     state=state, x=x, w=w))
    for r in got:
        np.testing.assert_allclose(r["out"], np.asarray(out), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(r["dx"], np.asarray(gx),
                                   atol=GRAD_ATOL, rtol=0)
        for n in ("qkv", "proj"):
            np.testing.assert_allclose(r[f"d{n}.weight"],
                                       np.asarray(gp[n]["kernel"]).T,
                                       atol=GRAD_ATOL, rtol=0)
            np.testing.assert_allclose(r[f"d{n}.bias"],
                                       np.asarray(gp[n]["bias"]),
                                       atol=GRAD_ATOL, rtol=0)


def test_mesh_layout_and_sharding_rules():
    mesh = ProcessMesh({"sp": 4, "dp": 1}, torch.device("cpu"), rank=2)
    assert mesh.axis_names == ("dp", "sp") and mesh.size == 4
    assert mesh.coords == {"dp": 0, "sp": 2}
    assert mesh.group_ranks("sp") == [0, 1, 2, 3]
    assert mesh.group_ranks("dp") == [2]
    assert mesh_axis_size("sp", mesh) == 4
    assert mesh_axis_size("tp", mesh) == 1
    assert data_parallelism(mesh) == 1
    batch = {"x": np.arange(12).reshape(6, 2), "y": [np.arange(6)]}
    got = shard_batch(batch, mesh)
    assert torch.equal(got["x"], torch.arange(12).reshape(6, 2))
    assert torch.equal(got["y"][0], torch.arange(6))
    # the rules give JAX's specs on a mesh of the same axes and sizes
    jmesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("fsdp", "tp"))
    pmesh = ProcessMesh({"fsdp": 2, "tp": 4}, None)
    rules = {"kernel": "tp,fsdp", "embed": "tp:0", "bias": None}
    for path, shape in ((("layer", "kernel"), (64, 128)),
                        (("embed",), (100, 8)), (("embed",), (102, 8)),
                        (("layer", "bias"), (128,)), (("other",), (4, 4))):
        want = jax_sharding.logical_to_sharding(rules, path, shape, jmesh)
        assert logical_to_sharding(rules, path, shape, pmesh) == \
            tuple(want.spec), path
    specs = infer_param_shardings(
        {"enc.kernel": torch.zeros(64, 128), "enc.bias": torch.zeros(128)},
        pmesh, rules)
    assert specs == {"enc.kernel": ("fsdp", "tp"), "enc.bias": ()}
