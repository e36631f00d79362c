"""The port's host KV tier (analytics_zoo_tpu_torch/serving/generation/
host_tier.py, the prefix cache's spill and restore, the engine's restore
write and staging) held against the JAX package's: byte accounting, LRU
order, geometry guards and `match_tokens` on the same operations; the
spill -> restore round trip with greedy streams identical to the JAX
engine's (f32 and int8 pools); the staged and synchronous restore paths;
the `generation.host_restore` fault and a refused restore write each
falling back to recompute with identical streams; a staged entry lost to
eviction; and nothing pinned on the CPU.  Streams and counts compared
exactly."""

import numpy as np
import pytest
import torch

from _torch_generation_cases import (
    VOCAB,
    assert_greedy,
    idle_residency,
    jax_engine,
    jax_params,
    port_engine,
    port_model,
    serve,
)
from analytics_zoo_tpu.observability.registry import MetricsRegistry
from analytics_zoo_tpu.serving.generation import (
    PagedKVCache as JaxPagedKVCache,
)
from analytics_zoo_tpu.serving.generation.host_tier import (
    HostKVTier as JaxHostKVTier,
)
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.serving.generation import (
    HostKVTier,
    PagedKVCache,
)
from analytics_zoo_tpu_torch.serving.generation.host_tier import (
    dma_events,
    reset_dma,
)

TIER = dict(max_slots=2, block_size=8, max_context=64, prefix_caching=True,
            chunked_prefill=True, kv_host_tier=1 << 20)


@pytest.fixture(scope="module")
def weights():
    params = jax_params()
    return params, port_model(params)


def _tiers(capacity, geometry=None):
    jt = JaxHostKVTier(capacity, registry=MetricsRegistry())
    pt = HostKVTier(capacity)
    if geometry is not None:
        jt.bind_geometry(JaxPagedKVCache(**geometry))
        pt.bind_geometry(PagedKVCache(**geometry, device="cpu"))
    return jt, pt


def _both_state(jt, pt):
    assert len(pt) == len(jt) and pt.bytes_used == jt.bytes_used
    assert list(pt._entries) == list(jt._entries)
    assert (pt.n_spilled, pt.n_evictions, pt.n_restored,
            pt.n_restore_failed) == (
        jt._c_spilled.value, jt._c_evictions.value,
        jt._c_restored.value, jt._c_restore_failed.value)


# ----------------------------------------------------------------------
# the tier alone, against JAX
# ----------------------------------------------------------------------

def test_tier_lru_bounded_bytes_and_dedupe_match_jax():
    jt, pt = _tiers(300)
    kv_np = np.zeros((1, 2, 4, 1, 4), np.float32)          # 128 bytes
    kv = torch.zeros(1, 2, 4, 1, 4)
    script = [("put", (1, 2, 3, 4)), ("put", (1, 2, 3, 4, 5, 6, 7, 8)),
              ("put", (1, 2, 3, 4)), ("put", (9, 9, 9, 9)),
              ("fetch", (1, 2, 3, 4, 5, 6, 7, 8)), ("fetch", (1, 2, 3, 4)),
              ("put", (5, 5, 5, 5)), ("fetch", (9, 9, 9, 9))]
    for op, key in script:
        if op == "put":
            assert pt.put(key, kv, None) == jt.put(key, kv_np, None)
        else:
            assert (pt.fetch(key) is None) == (jt.fetch(key) is None)
        _both_state(jt, pt)
    # an entry larger than the whole capacity is refused outright
    assert not pt.put((7,), torch.zeros(1, 2, 64, 1, 4), None)
    assert (len(pt), pt.bytes_used) == (2, 256)
    assert pt.clear() == jt.clear() == 2
    _both_state(jt, pt)


def test_tier_geometry_guard_matches_jax():
    geo = dict(n_layers=1, num_blocks=8, block_size=4, n_head=1,
               head_dim=4)
    jt, pt = _tiers(1 << 16, geo)
    good = torch.zeros(1, 2, 4, 1, 4)
    cases = [(good, None), (torch.zeros(1, 2, 8, 1, 4), None),
             (good, torch.zeros(1, 2, 4)),
             (good.to(torch.float16), None)]
    for i, (kv, scale) in enumerate(cases):
        want = jt.put((i,), kv.numpy(),
                      None if scale is None else scale.numpy())
        assert pt.put((i,), kv, scale) == want
    assert len(pt) == len(jt) == 1
    jt.bind_geometry(JaxPagedKVCache(**dict(geo, block_size=8)))
    pt.bind_geometry(PagedKVCache(**dict(geo, block_size=8), device="cpu"))
    assert len(pt) == len(jt) == 0


def test_match_tokens_is_read_only_and_matches_jax():
    geo = dict(n_layers=1, num_blocks=8, block_size=4, n_head=1,
               head_dim=4)
    jt, pt = _tiers(1 << 16, geo)
    toks = list(range(12))
    for n in (4, 8):
        jt.put(tuple(toks[:n]), np.zeros((1, 2, 4, 1, 4), np.float32), None)
        pt.put(tuple(toks[:n]), torch.zeros(1, 2, 4, 1, 4), None)
    order = list(pt._entries)
    for q in (toks, toks[:8], toks[:5], [5] + toks[1:], []):
        assert pt.match_tokens(q) == jt.match_tokens(q)
    assert pt.match_tokens(toks) == 8
    assert list(pt._entries) == order and pt.n_restored == 0


# ----------------------------------------------------------------------
# the engine: spill on evict, restore on miss, against the JAX engine
# ----------------------------------------------------------------------

def _evict_all(engine):
    return engine.prefix_cache.evict(1 << 10)


@pytest.mark.parametrize("kv_quantization", [None, "int8"],
                         ids=["f32", "int8"])
def test_spill_restore_round_trip_matches_jax(weights, kv_quantization):
    """Serve, evict the whole tree (every block spills), serve the same
    prompt again: the prefix comes back from the host, only the tail
    prefills, and the streams, spills, restores and prefilled tokens
    equal the JAX engine's."""
    params, model = weights
    p = list(np.random.default_rng(21).integers(0, VOCAB, 24))
    kw = dict(TIER, kv_quantization=kv_quantization)
    je, pe = jax_engine(params, **kw), port_engine(model, **kw)
    reset_dma()
    assert serve(pe, [(p, 6)]) == serve(je, [(p, 6)])
    freed = _evict_all(pe)
    assert freed == _evict_all(je) >= 3
    assert pe.host_tier.n_spilled == freed
    assert sum(e["kind"] == "host_spill" for e in dma_events()) == freed
    prefilled = pe.n_prefill_tokens
    (out,) = serve(pe, [(p, 6)])
    assert [out] == serve(je, [(p, 6)])
    assert pe.host_tier.n_restored == int(je.host_tier._c_restored.value)
    assert pe.n_host_restores == pe.host_tier.n_restored >= 2
    assert pe.n_prefill_tokens - prefilled == len(p) - 16
    restores = [e for e in dma_events() if e["kind"] == "host_restore"]
    assert len(restores) == pe.n_host_restores
    assert all(e["nbytes"] == pe.host_tier._entries[k].nbytes
               for e, k in zip(restores, list(pe.host_tier._entries)))
    if kv_quantization is None:
        assert_greedy(model, p, out)
    held, cached, shared = idle_residency(pe)
    assert held == cached and shared == 0
    assert pe.prefix_cache.n_spill_syncs == 0       # no card here


def test_staged_and_synchronous_restores(weights):
    """A five-block prefix comes back through both paths: the first two
    blocks from the copies staged before admission (depth 2), the rest
    copied at the restore; the stream is the one computed cold."""
    params, model = weights
    p = list(np.random.default_rng(22).integers(0, VOCAB, 44))
    kw = dict(TIER, max_context=64)
    pe = port_engine(model, **kw)
    (out,) = serve(pe, [(p, 6)])
    _evict_all(pe)
    assert serve(pe, [(p, 6)]) == [out]
    assert pe.n_host_restores == 5
    assert pe.n_host_restores_staged == 2 == pe.host_tier.n_staged
    assert [e["staged"] for e in dma_events()
            if e["kind"] == "host_restore"][-5:] == [True] * 2 + [False] * 3
    assert serve(jax_engine(params, **kw), [(p, 6)]) == [out]


def test_host_restore_fault_falls_back_to_recompute(weights):
    """An injected raise at `generation.host_restore` drops the entry
    and counts it; the lane recomputes the prefix, with no collateral
    eviction, and streams the same tokens as JAX's engine under the
    same fault."""
    params, model = weights
    p = list(np.random.default_rng(25).integers(0, VOCAB, 24))
    plan = {"faults": [{"site": "generation.host_restore", "at": 1,
                        "action": "raise"}]}
    pe = port_engine(model, **TIER)
    (out,) = serve(pe, [(p, 6)])
    _evict_all(pe)
    evictions, prefilled = pe.prefix_cache.n_evictions, pe.n_prefill_tokens
    OrcaContext.fault_plan = plan
    try:
        got = serve(pe, [(p, 6)])
    finally:
        OrcaContext.fault_plan = None
    assert got == [out]
    assert pe.host_tier.n_restore_failed == 1 and pe.n_host_restores == 0
    assert pe.prefix_cache.n_evictions == evictions
    assert pe.n_prefill_tokens - prefilled == len(p)
    from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
    je = jax_engine(params, **TIER)
    serve(je, [(p, 6)])
    _evict_all(je)
    JaxContext.fault_plan = {"faults": [dict(plan["faults"][0],
                                             action="nan")]}
    try:
        assert serve(je, [(p, 6)]) == got
    finally:
        JaxContext.fault_plan = None


def test_refused_restore_write_recomputes(weights):
    """An entry that does not fit the pool (here an int8 entry without
    its scales) is refused by the restore write: the block goes back to
    the pool, nothing restores, and the lane recomputes losslessly."""
    _, model = weights
    p = list(np.random.default_rng(26).integers(0, VOCAB, 24))
    pe = port_engine(model, **TIER, kv_quantization="int8")
    (out,) = serve(pe, [(p, 6)])
    _evict_all(pe)
    for entry in pe.host_tier._entries.values():
        entry.scale = None
    assert serve(pe, [(p, 6)]) == [out]
    assert pe.n_host_restores == 0 and pe.host_tier.n_restored == 0
    held, cached, shared = idle_residency(pe)
    assert held == cached and shared == 0


def test_staged_entry_lost_to_eviction_recomputes(weights):
    """A restore staged ahead of admission loses the race with the
    tier's eviction: the lane recomputes and streams the same tokens."""
    _, model = weights
    p = list(np.random.default_rng(24).integers(0, VOCAB, 24))
    pe = port_engine(model, **TIER)
    (out,) = serve(pe, [(p, 6)])
    _evict_all(pe)
    s = pe.submit(p, max_new_tokens=6)
    pe._stage_host_restores()
    assert any(e.staged_kv is not None
               for e in pe.host_tier._entries.values())
    pe.host_tier.clear()
    pe.run_until_idle()
    assert s.tokens() == out and pe.n_host_restores == 0


def test_only_unreferenced_blocks_spill_and_none_twice(weights):
    """A pinned leaf blocks eviction (nothing spills); released, the
    chain peels leaves first.  Restored blocks hold one lane and one
    tree reference, a second evict frees each once, and the tier keeps
    one entry per key."""
    _, model = weights
    p = list(np.random.default_rng(23).integers(0, VOCAB, 24))
    pe = port_engine(model, **TIER)
    serve(pe, [(p, 4)])
    a = pe.cache.allocator
    pin = pe.prefix_cache._evictable()[0].block
    a.share([pin])
    assert _evict_all(pe) == 0 and pe.host_tier.n_spilled == 0
    a.free([pin])
    assert _evict_all(pe) >= 3 and a.available() == a.capacity
    entries = len(pe.host_tier)
    serve(pe, [(p, 4)])
    assert pe.n_host_restores >= 2
    nb = pe.prefix_cache.n_blocks
    assert _evict_all(pe) == nb and a.available() == a.capacity
    assert len(pe.host_tier) == entries


def test_nothing_pinned_on_the_cpu(weights):
    _, model = weights
    pe = port_engine(model, **TIER, kv_quantization="int8")
    serve(pe, [(list(range(1, 25)), 4)])
    _evict_all(pe)
    assert len(pe.host_tier) >= 3
    for e in pe.host_tier._entries.values():
        assert not e.kv.is_pinned() and not e.scale.is_pinned()
        assert e.kv.dtype == torch.int8 and e.kv.device.type == "cpu"
    assert pe.host_tier._side_stream is None


def test_tier_off_by_default_and_knob_plumbs(weights):
    """`kv_host_tier_bytes` defaults to 0 (no tier, eviction drops
    blocks, no copy recorded), rejects negatives, and an "auto" engine
    reads it; without prefix caching there is never a tier."""
    _, model = weights
    assert OrcaContext.kv_host_tier_bytes == 0
    with pytest.raises(ValueError):
        OrcaContext.kv_host_tier_bytes = -1
    reset_dma()
    pe = port_engine(model, **dict(TIER, kv_host_tier="auto"))
    assert pe.host_tier is None and pe.prefix_cache.host_tier is None
    serve(pe, [(list(range(1, 25)), 2)])
    assert _evict_all(pe) >= 3 and dma_events() == []
    OrcaContext.kv_host_tier_bytes = 1 << 20
    try:
        assert port_engine(model, **dict(TIER, kv_host_tier="auto")) \
            .host_tier.capacity_bytes == 1 << 20
        assert port_engine(model, **dict(
            TIER, kv_host_tier="auto", prefix_caching=False)) \
            .host_tier is None
    finally:
        OrcaContext.kv_host_tier_bytes = 0
    shared = HostKVTier(1 << 20)
    assert port_engine(model, **dict(TIER, kv_host_tier=shared)) \
        .host_tier is shared
