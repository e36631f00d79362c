"""Chunked prefill in the port's engine (the chunk step, the scheduler's
chunk mode and the prefill round) held against the JAX engine: chunked
greedy streams identical to JAX's chunked engine and to the port's
whole-prompt engine (f32 and int8 pools); the round structure (the
decode lanes emit between a long prompt's chunks); and with every
feature off, the whole-prompt path with its launch counts as before
(counted on the CPU as the calls that launch K1 and K6 on the card:
LayerNorm forwards and paged-decode reads) — and the counts of a mixed
round with every feature on.  f32 on the CPU; streams compared
exactly."""

import numpy as np
import pytest

from _torch_generation_cases import (
    CFG,
    VOCAB,
    assert_greedy,
    cycle_params,
    cycle_perm,
    chain,
    jax_engine,
    jax_params,
    port_engine,
    port_model,
    serve,
)
import analytics_zoo_tpu_torch.serving.generation.model as port_model_mod
from analytics_zoo_tpu_torch.ops.normalization import LayerNorm

GEOM = dict(max_slots=4, block_size=8, max_context=128)
L = CFG["n_block"]


@pytest.fixture(scope="module")
def weights():
    params = jax_params()
    return params, port_model(params)


def _requests(seed):
    rng = np.random.default_rng(seed)
    return [(list(rng.integers(0, VOCAB, n)), new)
            for n, new in ((100, 6), (5, 20), (37, 12), (64, 8), (9, 16))]


@pytest.mark.parametrize("kv_quantization", [None, "int8"],
                         ids=["f32", "int8"])
def test_chunked_streams_match_jax_and_whole_prompt(weights,
                                                    kv_quantization):
    params, model = weights
    reqs = _requests(1)
    kw = dict(GEOM, chunked_prefill=True, prefill_token_budget=16,
              kv_quantization=kv_quantization)
    want = serve(jax_engine(params, **kw), reqs)
    pe = port_engine(model, **kw)
    pe.warmup()
    got = serve(pe, reqs)
    assert got == want
    assert got == serve(port_engine(model, **dict(
        GEOM, kv_quantization=kv_quantization)), reqs)
    # the 100-token prompt alone took ceil(100 / 16) chunks
    assert pe.n_chunks >= 7 + 4 and pe.n_prefills == 0
    assert pe.n_prefill_tokens == sum(len(p) for p, _ in reqs)


def test_chunk_cap_is_largest_bucket_in_budget(weights):
    params, model = weights
    for budget, cap in ((16, 16), (100, 64), (8, 16), (4096, 128)):
        kw = dict(GEOM, chunked_prefill=True, prefill_token_budget=budget)
        pe, je = port_engine(model, **kw), jax_engine(params, **kw)
        assert pe._chunk_cap == je._chunk_cap == cap
        assert pe.scheduler.expected_prefill_variants() == \
            je.scheduler.expected_prefill_variants() == 4


def test_decode_lanes_emit_between_chunks(weights):
    """A 100-token prompt arriving while a lane decodes spreads over at
    least 6 rounds of a 16-token budget, and the decoding lane gains a
    token in every one of them; both streams equal JAX's."""
    params, model = weights
    kw = dict(max_slots=2, block_size=8, max_context=128,
              chunked_prefill=True, prefill_token_budget=16)
    pe = port_engine(model, **kw)
    rng = np.random.default_rng(2)
    p_short = list(rng.integers(0, VOCAB, 6))
    long_p = list(rng.integers(0, VOCAB, 100))
    short = pe.submit(p_short, max_new_tokens=24)
    pe.step()
    assert short.seq.status == "running"
    long = pe.submit(long_p, max_new_tokens=4)
    rounds = 0
    while long.seq.status in ("waiting", "prefilling"):
        before = len(short.seq.generated)
        pe.step()
        rounds += 1
        assert len(short.seq.generated) == before + 1
        assert rounds < 60
    assert rounds >= 6
    pe.run_until_idle()
    got = [long.tokens(), short.tokens()]
    je = jax_engine(params, **kw)
    js = je.submit(p_short, max_new_tokens=24)
    je.step()
    jl = je.submit(long_p, max_new_tokens=4)
    je.run_until_idle()
    assert got == [jl.tokens(), js.tokens()]
    assert_greedy(model, long_p, got[0])


class _Calls:
    """Counts, on a CPU model, the calls that launch a kernel on the
    card: LayerNorm forwards (K1) and paged-decode reads (K6)."""

    def __init__(self, model, monkeypatch):
        self.k1 = self.k6 = 0
        for m in model.modules():
            if isinstance(m, LayerNorm):
                m.register_forward_hook(self._ln)
        real = port_model_mod.paged_decode_attention

        def counted(*a, **kw):
            self.k6 += 1
            return real(*a, **kw)
        monkeypatch.setattr(port_model_mod, "paged_decode_attention",
                            counted)

    def _ln(self, *_):
        self.k1 += 1

    def reset(self):
        self.k1 = self.k6 = 0


def test_features_off_keeps_the_whole_prompt_path(weights, monkeypatch):
    """Every feature off: no prefix cache, no chunk step, no verify; one
    whole-prompt prefill per admission and one decode step per round,
    2L + 1 LayerNorms a forward and L paged reads a decode step, and
    the JAX engine's streams."""
    params, _ = weights
    model = port_model(params)
    calls = _Calls(model, monkeypatch)
    pe = port_engine(model, **GEOM)
    assert pe.prefix_cache is None and pe.speculation is None
    assert pe._use_chunks is False and pe.host_tier is None
    pe.warmup()
    calls.reset()
    reqs = _requests(3)
    got = serve(pe, reqs)
    assert got == serve(jax_engine(params, **GEOM), reqs)
    assert pe.n_chunks == pe.n_verify_steps == pe.n_cow_copies == 0
    assert pe.n_prefills == len(reqs)
    assert calls.k1 == (2 * L + 1) * (pe.n_prefills + pe.n_decode_steps)
    assert calls.k6 == L * pe.n_decode_steps


def test_mixed_rounds_count_every_forward(weights, monkeypatch):
    """Prefix caching, chunked prefill and speculation on, over cycle
    and random traffic: chunk, decode and verify forwards each run
    2L + 1 LayerNorms, decode steps alone read the pool through the
    paged-decode path, and the sums add up exactly."""
    params, _ = weights
    perm = cycle_perm()
    model = port_model(cycle_params(params, perm))
    calls = _Calls(model, monkeypatch)
    pe = port_engine(model, **GEOM, prefix_caching=True,
                     chunked_prefill=True, prefill_token_budget=16,
                     speculative_decoding=True, speculative_k=4)
    pe.warmup()
    calls.reset()
    rng = np.random.default_rng(4)
    reqs = [(chain(perm, 3, 40), 20), (chain(perm, 7, 9), 16),
            (list(rng.integers(0, VOCAB, 21)), 12),
            (chain(perm, 3, 24) + [40, 41], 10)]
    outs = serve(pe, reqs)
    assert outs[0] == chain(perm, perm[reqs[0][0][-1]], 20)
    assert pe.n_chunks and pe.n_verify_steps and pe.n_decode_steps
    assert pe.n_spec_accepted > 0
    assert calls.k1 == (2 * L + 1) * (pe.n_prefills + pe.n_chunks
                                      + pe.n_decode_steps
                                      + pe.n_verify_steps)
    assert calls.k6 == L * pe.n_decode_steps
