"""The port's prefix cache (analytics_zoo_tpu_torch/serving/generation/
prefix_cache.py and the scheduler and engine paths that use it) held
against the JAX package's: the radix tree's lookup, commit, dedupe,
refcounts, LRU eviction order and peek on the same operation sequences;
engine greedy streams identical to the JAX engine's with prefix caching
on (f32 and int8 pools), through hits, misses and preemption of lanes
whose blocks are shared; copy-on-write carrying int8 scales; eviction
preferred over preemption; the `generation.prefix_lookup` fault.  All
f32 on the CPU; streams and counts are compared exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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
from analytics_zoo_tpu.observability import request_log
from analytics_zoo_tpu.observability.registry import MetricsRegistry
from analytics_zoo_tpu.serving.generation import (
    PagedKVCache as JaxPagedKVCache,
    PrefixCache as JaxPrefixCache,
)
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.resilience.faults import SimulatedWorkerFailure
from analytics_zoo_tpu_torch.serving.generation import (
    PagedKVCache,
    PrefixCache,
)

GEOM = dict(max_slots=4, block_size=8, max_context=64)


@pytest.fixture(scope="module", autouse=True)
def _reset_jax_request_log():
    """The JAX engines this module drives write into the JAX package's
    process-global request log, and a preempted request's record there
    counts its recomputed prefill; `tests/test_speculation.py` checks
    every finished record of that log, so the log is reset when the
    module ends."""
    yield
    request_log.reset_request_log()


@pytest.fixture(scope="module")
def weights():
    params = jax_params()
    return params, port_model(params)


# ----------------------------------------------------------------------
# the radix tree, operation by operation against JAX
# ----------------------------------------------------------------------

def _trees(num_blocks=16, bs=4):
    jc = JaxPagedKVCache(n_layers=1, num_blocks=num_blocks, block_size=bs,
                         n_head=1, head_dim=4)
    pc = PagedKVCache(n_layers=1, num_blocks=num_blocks, block_size=bs,
                      n_head=1, head_dim=4, device="cpu")
    return (JaxPrefixCache(jc, registry=MetricsRegistry()),
            PrefixCache(pc))


def _state(tree, jax_side):
    a = tree.allocator
    counters = ((tree._c_hits.value, tree._c_misses.value,
                 tree._c_hit_tokens.value, tree._c_evictions.value)
                if jax_side else
                (tree.n_hits, tree.n_misses, tree.n_hit_tokens,
                 tree.n_evictions))
    return (dict(a._refs), list(a._free), tree.n_blocks, a.n_shared(),
            tuple(int(c) for c in counters))


def test_radix_lookup_commit_dedupe_evict_matches_jax():
    """The JAX test's script (tests/test_prefix_cache.py) on both trees:
    a miss, a commit, capped lookups, a deduping commit, releases, a
    pinned leaf that blocks eviction, LRU eviction, clear."""
    jt, pt = _trees(num_blocks=12)
    toks = list(range(10))

    def both(fn):
        a, b = fn(jt), fn(pt)
        assert a == b
        assert _state(jt, True) == _state(pt, False)
        return b

    assert both(lambda t: t.lookup(toks)) == ([], 0)
    table = both(lambda t: t.allocator.alloc(3))
    assert both(lambda t: t.commit(toks, table)) == table
    got = both(lambda t: t.lookup(toks))
    got2 = both(lambda t: t.lookup(toks[:8]))
    assert got == (table[:2], 8) and got2 == (table[:1], 4)
    both(lambda t: t.allocator.free(got[0] + got2[0]))
    dup = both(lambda t: t.allocator.alloc(3))
    deduped = both(lambda t: t.commit(toks, dup))
    assert deduped[:2] == table[:2] and deduped[2] == dup[2]
    both(lambda t: t.allocator.free(table))
    both(lambda t: t.allocator.free(deduped))
    assert both(lambda t: t.peek(toks)) == 8
    both(lambda t: t.allocator.share([table[1]]))
    assert both(lambda t: t.evict(8)) == 0
    both(lambda t: t.allocator.free([table[1]]))
    assert both(lambda t: t.evict(1)) == 1
    assert both(lambda t: t.clear()) == 1
    assert pt.allocator.available() == pt.allocator.capacity


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_random_operations_match_jax(seed):
    """Random interleavings of admissions (lookup + alloc), commits,
    releases, evictions and peeks over prompts that share prefixes:
    every return value, refcount, free-list order and counter equal
    after every operation."""
    bs = 4
    jt, pt = _trees(num_blocks=24, bs=bs)
    rng = np.random.default_rng(seed)
    stems = [list(rng.integers(0, 5, 12)) for _ in range(3)]
    live = []                            # [(tokens, table)]
    for _ in range(120):
        op = rng.integers(0, 5)
        if op == 0 or not live:
            toks = list(stems[rng.integers(0, 3)][:rng.integers(1, 13)]) \
                + list(rng.integers(0, 5, rng.integers(0, 6)))
            got = jt.lookup(toks)
            assert pt.lookup(toks) == got
            need = -(-len(toks) // bs) - len(got[0])
            fresh = jt.allocator.alloc(need)
            assert pt.allocator.alloc(need) == fresh
            if fresh is None:
                jt.allocator.free(got[0])
                pt.allocator.free(got[0])
            else:
                live.append((toks, got[0] + fresh))
        elif op == 1:
            i = int(rng.integers(len(live)))
            toks, table = live[i]
            new = jt.commit(toks, table)
            assert pt.commit(toks, table) == new
            live[i] = (toks, new)
        elif op == 2:
            toks, table = live.pop(int(rng.integers(len(live))))
            jt.allocator.free(table)
            pt.allocator.free(table)
        elif op == 3:
            n = int(rng.integers(1, 6))
            assert pt.evict(n) == jt.evict(n)
        else:
            toks = stems[rng.integers(0, 3)]
            assert pt.peek(toks) == jt.peek(toks)
        assert _state(jt, True) == _state(pt, False)
    assert pt.hit_rate() == pytest.approx(jt.hit_rate())
    assert pt.n_lookups == pt.n_hits + pt.n_misses


def test_allocator_sharing_counts_match_jax():
    """`n_shared` and the pool's `nbytes` (logical against physical) as
    JAX reports them, f32 and int8."""
    for quant in (None, "int8"):
        jc = JaxPagedKVCache(2, 9, 4, 2, 8, dtype=jnp.float16,
                             quantization=quant)
        pc = PagedKVCache(2, 9, 4, 2, 8, dtype=torch.float16,
                          quantization=quant, device="cpu")
        for c in (jc, pc):
            got = c.allocator.alloc(3)
            c.allocator.share(got[:2])
            c.allocator.share(got[:1])
        assert pc.allocator.n_shared() == jc.allocator.n_shared() == 2
        assert (pc.nbytes, pc.logical_nbytes) == (jc.nbytes,
                                                  jc.logical_nbytes)


# ----------------------------------------------------------------------
# the engine with prefix caching, against the JAX engine
# ----------------------------------------------------------------------

def _shared_prefix_requests(seed, n, new):
    rng = np.random.default_rng(seed)
    shared = list(rng.integers(0, VOCAB, 16))       # two full blocks
    return [(shared + list(rng.integers(0, VOCAB, int(rng.integers(1, 9)))),
             new) for _ in range(n)]


@pytest.mark.parametrize("kv_quantization", [None, "int8"],
                         ids=["f32", "int8"])
def test_prefix_hit_streams_match_jax(weights, kv_quantization):
    """A first wave fills the tree, a second hits it: identical streams,
    hits and prefilled tokens (only the tails once the prefix is
    cached); the tree alone holds blocks when idle."""
    params, model = weights
    reqs = _shared_prefix_requests(1, 5, 8)
    kw = dict(GEOM, prefix_caching=True, kv_quantization=kv_quantization)
    je, pe = jax_engine(params, **kw), port_engine(model, **kw)
    for wave in (reqs[:1], reqs[1:]):
        assert serve(pe, wave) == serve(je, wave)
    assert pe.n_prefill_tokens == int(je._c_prefill_tokens.value)
    assert (pe.prefix_cache.n_hits, pe.prefix_cache.n_hit_tokens) == (
        int(je.prefix_cache._c_hits.value),
        int(je.prefix_cache._c_hit_tokens.value))
    assert pe.prefix_cache.n_hits >= 4
    for (p, _), out in zip(reqs, serve(pe, reqs)):
        assert_greedy(model, p, out)
    held, cached, shared = idle_residency(pe)
    assert held == cached and shared == 0
    assert pe._kv_pool_stats()["blocks_cached"] == cached


@pytest.mark.parametrize("kv_quantization", [None, "int8"],
                         ids=["f32", "int8"])
def test_preempted_shared_lane_streams_match_jax(weights, kv_quantization):
    """9 allocatable blocks for 4 lanes sharing a 2-block prefix: lanes
    are preempted while their prefix blocks are shared with the tree and
    each other, resume, and every stream equals JAX's."""
    params, model = weights
    reqs = _shared_prefix_requests(3, 5, 16)
    kw = dict(GEOM, num_blocks=10, prefix_caching=True,
              chunked_prefill=True, kv_quantization=kv_quantization)
    je, pe = jax_engine(params, **kw), port_engine(model, **kw)
    want = serve(je, reqs)
    got = serve(pe, reqs)
    assert got == want and all(len(t) == 16 for t in got)
    assert pe.scheduler.n_preemptions == je.scheduler.n_preemptions > 0
    held, cached, shared = idle_residency(pe)
    assert held == cached and shared == 0


def test_cow_copies_block_and_int8_scales(weights):
    """A lane's write block shared by a second holder is un-shared
    before the decode write: the fresh block holds the source's int8
    rows and scales, the holder's block is untouched, and the stream is
    that of the same request served with no copy."""
    _, model = weights
    kw = dict(max_slots=2, block_size=8, max_context=64,
              prefix_caching=True, kv_quantization="int8")
    pe = port_engine(model, **kw)
    p = list(np.random.default_rng(4).integers(0, VOCAB, 12))
    s = pe.submit(p, max_new_tokens=10)
    pe.step()                                   # prefill + one decode
    seq = s.seq
    idx = (seq.context_len - 1) // 8
    src = seq.block_table[idx]
    pe.cache.allocator.share([src])             # a fork's hold
    bs = pe.cache.block_size
    rows = pe.cache.kv[:, :, src * bs:(src + 1) * bs].clone()
    scales = pe.cache.kv_scale[:, :, src * bs:(src + 1) * bs].clone()
    pe.scheduler.ensure_decode_capacity()
    pe._apply_cow()
    dst = seq.block_table[idx]
    assert dst != src and pe.n_cow_copies == 1
    assert pe.cache.allocator.ref_count(src) == 1
    assert torch.equal(pe.cache.kv[:, :, dst * bs:(dst + 1) * bs], rows)
    assert torch.equal(pe.cache.kv_scale[:, :, dst * bs:(dst + 1) * bs],
                       scales)
    assert not torch.equal(scales, torch.ones_like(scales))
    pe.run_until_idle()
    assert torch.equal(pe.cache.kv[:, :, src * bs:(src + 1) * bs], rows)
    pe.cache.allocator.free([src])
    assert s.tokens() == port_engine(model, **kw).generate(
        p, max_new_tokens=10)


def test_eviction_prefers_cache_over_preemption(weights):
    """Two finished prompts fill the tree; a third needs their space:
    cached blocks are evicted, no lane is preempted, and the counts and
    streams equal JAX's."""
    params, model = weights
    rng = np.random.default_rng(5)
    reqs = [(list(rng.integers(0, VOCAB, 24)), 2) for _ in range(2)]
    last = [(list(rng.integers(0, VOCAB, 30)), 8)]
    kw = dict(max_slots=2, block_size=8, max_context=64, num_blocks=10,
              prefix_caching=True)
    je, pe = jax_engine(params, **kw), port_engine(model, **kw)
    for wave in (reqs[:1], reqs[1:]):
        assert serve(pe, wave) == serve(je, wave)
    assert pe.prefix_cache.n_blocks == 6 == idle_residency(pe)[0]
    assert serve(pe, last) == serve(je, last)
    assert pe.prefix_cache.n_evictions == int(
        je.prefix_cache._c_evictions.value) > 0
    assert pe.scheduler.n_preemptions == 0


def test_generated_suffix_is_committed(weights):
    """A finished request publishes prompt + generated whole blocks, so
    a follow-up turn that extends it hits past its prompt, as in JAX."""
    params, model = weights
    rng = np.random.default_rng(6)
    p = list(rng.integers(0, VOCAB, 13))
    kw = dict(GEOM, prefix_caching=True, chunked_prefill=True)
    je, pe = jax_engine(params, **kw), port_engine(model, **kw)
    (out,) = serve(pe, [(p, 12)])
    assert serve(je, [(p, 12)]) == [out]
    turn = [(p + out + list(rng.integers(0, VOCAB, 3)), 4)]
    assert serve(pe, turn) == serve(je, turn)
    assert pe.prefix_cache.n_hit_tokens == 24 == int(
        je.prefix_cache._c_hit_tokens.value)


def test_prefix_lookup_fault_fails_one_request_cleanly(weights):
    """An injected raise at `generation.prefix_lookup` fails the
    admission; the tree survives, and the same prompt then serves the
    same tokens and hits."""
    _, model = weights
    pe = port_engine(model, max_slots=2, block_size=8, max_context=64,
                     prefix_caching=True)
    p = list(np.random.default_rng(6).integers(0, VOCAB, 12))
    out = pe.generate(p, max_new_tokens=4)
    OrcaContext.fault_plan = {"faults": [
        {"site": "generation.prefix_lookup", "at": 1, "action": "raise"}]}
    try:
        s = pe.submit(p, max_new_tokens=4)
        with pytest.raises(SimulatedWorkerFailure):
            pe.run_until_idle()
    finally:
        OrcaContext.fault_plan = None
    assert s.seq.status == "waiting" and not s.seq.block_table
    pe.scheduler.waiting.clear()
    held, cached, shared = idle_residency(pe)
    assert held == cached == 1 and shared == 0
    hits = pe.prefix_cache.n_hits
    assert pe.generate(p, max_new_tokens=4) == out
    assert pe.prefix_cache.n_hits == hits + 1
