"""The port's runtime entry points against the JAX package's
(`common/context.py`): JAX's `tests/test_context.py` cases for "local"
and the bad mode, the re-init rules, the implicit start through
`OrcaContext.device`, `cores`, the atexit hook and the modes the port
refuses.  JAX returns a `Mesh`, the port the device it runs on."""

import atexit
import os

import pytest
import torch

import analytics_zoo_tpu as jax_pkg
import analytics_zoo_tpu_torch as port_pkg
from analytics_zoo_tpu_torch.common import context as port_ctx


@pytest.fixture(autouse=True)
def _stopped():
    port_pkg.stop_orca_context()
    yield
    port_pkg.stop_orca_context()


@pytest.fixture
def jax_stopped():
    """JAX's context stopped for a test, then started again in local
    mode if it was running (other JAX tests in the worker read it)."""
    was = jax_pkg.OrcaContext.initialized
    jax_pkg.stop_orca_context()
    yield
    jax_pkg.stop_orca_context()
    if was:
        jax_pkg.init_orca_context(cluster_mode="local")


def test_the_root_exports_the_entry_points_as_jax_does():
    names = ("OrcaContext", "init_orca_context", "init_nncontext",
             "stop_orca_context")
    for name in names:
        assert hasattr(jax_pkg, name)
        assert getattr(port_pkg, name) is getattr(port_ctx, name)
    assert set(names) <= set(port_pkg.__all__)
    from analytics_zoo_tpu_torch import common
    assert common.init_orca_context is port_pkg.init_orca_context


def test_init_local_returns_the_device(jax_stopped):
    mesh = jax_pkg.init_orca_context(cluster_mode="local")
    dev = port_pkg.init_orca_context(cluster_mode="local", device="cpu")
    assert dev == torch.device("cpu")
    for ctx in (jax_pkg.OrcaContext, port_pkg.OrcaContext):
        assert ctx.initialized and ctx.cluster_mode == "local"
    assert port_pkg.OrcaContext.device == dev
    assert port_pkg.OrcaContext.devices == [dev]
    assert port_pkg.OrcaContext.num_devices == 1
    assert jax_pkg.OrcaContext.num_devices == mesh.devices.size


def test_a_second_call_returns_the_first_result(jax_stopped):
    mesh = jax_pkg.init_orca_context(cluster_mode="local")
    assert jax_pkg.init_orca_context(cluster_mode="LOCAL") is mesh
    dev = port_pkg.init_orca_context(cluster_mode="local", device="cpu")
    # the mode is lower-cased, and the device of a later call is not read
    assert port_pkg.init_orca_context(cluster_mode="LOCAL",
                                      device="meta") is dev
    assert port_pkg.init_nncontext(device="cpu") is dev


@pytest.mark.parametrize("mode", ["yarn", "k8s", "standalone"])
def test_bad_cluster_mode_raises_jax_error(jax_stopped, mode):
    with pytest.raises(ValueError) as want:
        jax_pkg.init_orca_context(cluster_mode=mode)
    with pytest.raises(ValueError) as got:
        port_pkg.init_orca_context(cluster_mode=mode, device="cpu")
    assert str(got.value) == str(want.value)
    assert not port_pkg.OrcaContext.initialized


def test_another_configuration_raises_until_stopped(jax_stopped):
    jax_pkg.init_orca_context(cluster_mode="local")
    port_pkg.init_orca_context(cluster_mode="local", device="cpu")
    for kw in (dict(cluster_mode="yarn"), dict(cluster_mode="tpu_pod"),
               dict(cluster_mode="local", mesh_shape={"dp": 1})):
        with pytest.raises(RuntimeError) as want:
            jax_pkg.init_orca_context(**kw)
        with pytest.raises(RuntimeError) as got:
            port_pkg.init_orca_context(device="cpu", **kw)
        assert str(got.value) == str(want.value)
    port_pkg.stop_orca_context()
    assert not port_pkg.OrcaContext.initialized
    assert port_pkg.OrcaContext.cluster_mode is None
    assert port_pkg.init_orca_context(device="cpu",
                                      mesh_shape={"dp": 1}).type == "cpu"


def test_reading_the_device_starts_local_and_an_explicit_call_replaces_it(
        monkeypatch):
    """The implicit start resolves the default device (the card here,
    stood in for by the CPU).  JAX's `mesh` sets its flag on
    `OrcaContext`, not on the metaclass its `init_orca_context` reads,
    so JAX keeps its implicit start; the port replaces it, as JAX's
    rule says (context.py:931-935)."""
    from analytics_zoo_tpu_torch import device as device_mod

    calls = []

    def resolve(device=None):
        calls.append(device)
        return torch.device("cpu" if device is None else device)
    monkeypatch.setattr(device_mod, "resolve_device", resolve)
    assert port_pkg.OrcaContext.device == torch.device("cpu")
    assert calls == [None]
    assert port_pkg.OrcaContext.initialized
    assert port_ctx.OrcaContextMeta._auto_initialized
    # an explicit call (even another mode's) replaces the implicit start
    with pytest.raises(ValueError, match="unsupported cluster_mode"):
        port_pkg.init_orca_context(cluster_mode="yarn")
    assert not port_pkg.OrcaContext.initialized
    port_pkg.OrcaContext.device
    dev = port_pkg.init_orca_context(cluster_mode="local", device="meta")
    assert dev == torch.device("meta")
    assert not port_ctx.OrcaContextMeta._auto_initialized
    assert port_pkg.init_orca_context(device="cpu") is dev


@pytest.mark.parametrize("kw", [dict(cluster_mode="tpu_pod",
                                     mesh_shape={"pp": 2}),
                                dict(cluster_mode="distributed",
                                     mesh_shape={"sp": 2, "dp": 2}),
                                dict(cluster_mode="distributed",
                                     num_processes=2),
                                dict(mesh_shape={"dp": 2}),
                                dict(mesh_shape={"tp": 1})],
                         ids=["tpu_pod", "distributed", "distributed_dp",
                              "dp2", "tp1"])
def test_multi_device_modes_are_not_ported(kw):
    """The distributed runtime and the "sp" axis are ported
    (tests/test_torch_ring_attention.py); every other axis and dp > 1,
    the default shape of several ranks included, still raise, before
    any process group starts."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 8b"):
        port_pkg.init_orca_context(device="cpu", **kw)
    assert not port_pkg.OrcaContext.initialized


def test_cores_sets_omp_threads_unless_set(monkeypatch):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    port_pkg.init_orca_context(cores=3, device="cpu")
    assert os.environ["OMP_NUM_THREADS"] == "3"
    port_pkg.stop_orca_context()
    port_pkg.init_orca_context(cores=5, device="cpu")
    assert os.environ["OMP_NUM_THREADS"] == "3"


def test_an_atexit_hook_stops_the_context(monkeypatch):
    hooks = []
    monkeypatch.setattr(atexit, "register", hooks.append)
    port_pkg.init_orca_context(device="cpu")
    assert hooks == [port_pkg.stop_orca_context]
    hooks[0]()
    assert not port_pkg.OrcaContext.initialized


def test_no_card_raises_and_starts_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pkg.init_orca_context(cluster_mode="local")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pkg.OrcaContext.device
    assert not port_pkg.OrcaContext.initialized


def test_orca_context_knobs_as_jax():
    """JAX's `test_orca_context_knobs` on the port's OrcaContext."""
    ctx = port_pkg.OrcaContext
    ctx.shard_size = 100
    assert ctx.shard_size == 100
    ctx.shard_size = None
    with pytest.raises(ValueError):
        ctx.train_data_store = "GPU"
    ctx.train_data_store = "DISK_4"
    assert ctx.train_data_store == "DISK_4"
    ctx.train_data_store = "DRAM"
