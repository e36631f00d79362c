"""Speculative decoding in the port (serving/generation/speculation.py,
`ops.attention.paged_verify_attention`, the model's paged t > 1 branch
and the engine's verify round) held against the JAX package: the
drafter, the cooldown and the bucket geometry bit-equal to JAX's on
hypothesis-drawn histories; `paged_verify_attention` against JAX's at
f32 (1e-5) and int8 (1e-4); the paged t > 1 branch against the ctx read
path (1e-5); engine greedy streams with speculation on identical to
speculation off and to the JAX engine's, on a wired cycle model and on
random prompts; the allocator back at idle after rollbacks; the
`generation.spec_verify` fault; and all four engine features together
against JAX."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_generation_cases import (
    CFG,
    VOCAB,
    assert_greedy,
    chain,
    cycle_params,
    cycle_perm,
    idle_residency,
    jax_engine,
    jax_params,
    port_engine,
    port_model,
    serve,
)
from analytics_zoo_tpu.ops.attention import (
    paged_verify_attention as jax_verify,
)
from analytics_zoo_tpu.serving.generation import (
    SpecState as JaxSpecState,
    Speculator as JaxSpeculator,
    ngram_draft as jax_ngram_draft,
)
from analytics_zoo_tpu.serving.generation.kv_cache import (
    quantize_kv_tokens as jax_quantize,
)
from analytics_zoo_tpu.serving.generation.scheduler import (
    Sequence as JaxSequence,
)
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.ops.attention import (
    _paged_dequant,
    dot_product_attention,
    paged_verify_attention,
)
from analytics_zoo_tpu_torch.serving.generation import (
    SpecState,
    Speculator,
    ngram_draft,
)
from analytics_zoo_tpu_torch.serving.generation.scheduler import Sequence

GEOM = dict(max_slots=4, block_size=8, max_context=128)
SPEC = dict(speculative_decoding=True, speculative_k=4)
histories = st.lists(st.integers(0, 5), max_size=40)


@pytest.fixture(scope="module")
def weights():
    params = jax_params()
    return params, port_model(params)


@pytest.fixture(scope="module")
def cyc(weights):
    params, _ = weights
    perm = cycle_perm()
    cparams = cycle_params(params, perm)
    return cparams, port_model(cparams), perm


# ----------------------------------------------------------------------
# the host-side drafter against JAX's
# ----------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(ctx=histories, k=st.integers(0, 6), lo=st.integers(1, 3),
       span=st.integers(0, 2), eos=st.one_of(st.none(), st.integers(0, 5)))
def test_ngram_draft_matches_jax(ctx, k, lo, span, eos):
    kw = dict(max_ngram=lo + span, min_ngram=lo, eos_id=eos)
    assert ngram_draft(ctx, k, **kw) == jax_ngram_draft(ctx, k, **kw)


@settings(max_examples=100, deadline=None)
@given(rounds=st.lists(st.tuples(st.integers(0, 4), st.integers(0, 4)),
                       max_size=30))
def test_spec_state_backoff_matches_jax(rounds):
    ours, theirs = SpecState(), JaxSpecState()
    for proposed, accepted in rounds:
        accepted = min(accepted, proposed)
        ours.record(proposed, accepted)
        theirs.record(proposed, accepted)
        assert [getattr(ours, f) for f in SpecState.__slots__] == \
            [getattr(theirs, f) for f in SpecState.__slots__]


@settings(max_examples=100, deadline=None)
@given(k=st.integers(1, 9), prompt=st.lists(st.integers(0, 4), min_size=1,
                                             max_size=24),
       new=st.integers(1, 8), done=st.integers(0, 7))
def test_speculator_matches_jax(k, prompt, new, done):
    ours, theirs = Speculator(k), JaxSpeculator(k)
    assert ours.buckets == theirs.buckets
    assert ours.expected_verify_variants() == \
        theirs.expected_verify_variants()
    for n in range(1, k + 1):
        assert ours.bucket_for(n) == theirs.bucket_for(n)
    with pytest.raises(ValueError, match="exceeds"):
        ours.bucket_for(k + 1)
    a = Sequence(prompt, max_new_tokens=new)
    b = JaxSequence(prompt, max_new_tokens=new)
    a.generated = b.generated = prompt[:min(done, new - 1)]
    assert ours.draft_for(a) == theirs.draft_for(b)
    assert ours.state(a) is ours.state(a)


def test_speculator_rejects_k_below_one():
    with pytest.raises(ValueError, match=">= 1"):
        Speculator(0)
    with pytest.raises(ValueError, match=">= 1"):
        OrcaContext.speculative_k = 0


# ----------------------------------------------------------------------
# the verify read
# ----------------------------------------------------------------------

def _verify_scene(seed, quantized):
    rng = np.random.default_rng(seed)
    S, T, h, d, bs, mb = 3, 5, 2, 8, 4, 6
    nb = S * mb + 1
    kv = rng.normal(size=(2, nb, bs, h, d)).astype(np.float32)
    q, k, v = (rng.normal(size=(S, T, h, d)).astype(np.float32)
               for _ in range(3))
    ctx = np.array([0, 7, 17], np.int32)
    tables = np.zeros((S, mb), np.int32)
    perm = 1 + rng.permutation(nb - 1)
    for s in range(S):
        used = -(-(int(ctx[s]) + T) // bs)
        tables[s, :used] = perm[s * mb:s * mb + used]
    scales = None
    if quantized:
        qkv, sc = jax_quantize(jnp.asarray(kv))
        kv, scales = np.array(qkv), np.array(sc)
    return q, k, v, kv, scales, tables, ctx


@pytest.mark.parametrize("quantized,tol", [(False, 1e-5), (True, 1e-4)],
                         ids=["f32", "int8"])
def test_paged_verify_attention_matches_jax(quantized, tol):
    q, k, v, kv, sc, tables, ctx = _verify_scene(7, quantized)
    want = jax_verify(q, k, v, kv[0], kv[1], tables, ctx,
                      k_scale=None if sc is None else sc[0],
                      v_scale=None if sc is None else sc[1])
    t = torch.from_numpy
    got = paged_verify_attention(
        t(q), t(k), t(v), t(kv[0]), t(kv[1]), t(tables), t(ctx),
        k_scale=None if sc is None else t(sc[0]),
        v_scale=None if sc is None else t(sc[1]))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)
    with pytest.raises(ValueError, match="impl"):
        paged_verify_attention(t(q), t(k), t(v), t(kv[0]), t(kv[1]),
                               t(tables), t(ctx), impl="kernel")


def test_paged_branch_t_gt_1_matches_ctx_path(weights):
    """The model's paged t > 1 branch against its ctx read over the
    same context gathered by hand (1e-5 on logits and K/V)."""
    _, model = weights
    rng = np.random.default_rng(8)
    L, h, d, bs, mb, S, T = CFG["n_block"], 4, 8, 4, 5, 3, 3
    nb = S * mb + 1
    pool = torch.from_numpy(
        rng.normal(size=(L, 2, nb, bs, h, d)).astype(np.float32))
    ctx = torch.tensor([1, 6, 12], dtype=torch.int32)
    tables = torch.from_numpy(
        (1 + rng.permutation(nb - 1)[:S * mb]).reshape(S, mb)
        .astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, VOCAB, (S, T)).astype(np.int32))
    pos = ctx[:, None] + torch.arange(T)[None]
    tok_idx = (tables.long()[:, :, None] * bs
               + torch.arange(bs)[None, None]).reshape(S, -1)
    flat = pool.reshape(L, 2, nb * bs, h, d)
    with torch.no_grad():
        got = model(ids, pos, kv_pool=pool, block_tables=tables,
                    ctx_len=ctx)
        want = model(ids, pos, ctx_k=flat[:, 0][:, tok_idx],
                     ctx_v=flat[:, 1][:, tok_idx], ctx_len=ctx)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    # the plain read it runs is `dot_product_attention` over the gather
    q = torch.randn(S, T, h, d)
    a = paged_verify_attention(q, q, q, pool[0, 0], pool[0, 1], tables,
                               ctx)
    b = dot_product_attention(
        q, q, q, ctx_k=_paged_dequant(pool[0, 0].reshape(-1, h, d), None,
                                      tok_idx),
        ctx_v=_paged_dequant(pool[0, 1].reshape(-1, h, d), None, tok_idx),
        ctx_len=ctx)
    assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kv_quantization", [None, "int8"],
                         ids=["f32", "int8"])
def test_cycle_streams_match_spec_off_and_jax(cyc, kv_quantization):
    """Cycle traffic drafts perfectly: the spec-on stream equals the
    spec-off one, the JAX spec-on one and the model's cycle, with the
    JAX engine's verify rounds, proposals and acceptances, and more
    tokens accepted than rounds."""
    cparams, cmodel, perm = cyc
    rng = np.random.default_rng(3)
    shared = chain(perm, 5, 16)
    reqs = [(shared + chain(perm, perm[shared[-1]], 4), 24),
            (shared + chain(perm, 11, 4), 24),
            (list(rng.integers(0, VOCAB, 11)), 24),
            (chain(perm, 20, 40), 24)]
    kw = dict(GEOM, kv_quantization=kv_quantization)
    pe = port_engine(cmodel, **kw, **SPEC)
    pe.warmup()
    got = serve(pe, reqs)
    assert got == serve(port_engine(cmodel, **kw), reqs)
    je = jax_engine(cparams, **kw, **SPEC)
    assert got == serve(je, reqs)
    assert got[0] == chain(perm, perm[reqs[0][0][-1]], 24)
    assert (pe.n_spec_rounds, pe.n_spec_proposed, pe.n_spec_accepted) == (
        int(je._c_spec_rounds.value), int(je._c_spec_proposed.value),
        int(je._c_spec_accepted.value))
    assert pe.n_spec_accepted > pe.n_spec_rounds > 0
    assert idle_residency(pe) == (0, 0, 0)


def test_random_prompt_streams_match_spec_off_and_jax(weights):
    params, model = weights
    rng = np.random.default_rng(9)
    reqs = [(list(rng.integers(0, VOCAB, int(n))), 20)
            for n in rng.integers(3, 30, 6)]
    pe = port_engine(model, **GEOM, **SPEC)
    got = serve(pe, reqs)
    assert got == serve(port_engine(model, **GEOM), reqs)
    assert got == serve(jax_engine(params, **GEOM, **SPEC), reqs)
    for (p, _), out in zip(reqs, got):
        assert_greedy(model, p, out)
    assert pe.n_spec_rounds > 0


def test_allocator_idle_after_rollbacks(cyc):
    """Waves of accepted and rejected verify rounds, under a pool tight
    enough to preempt: every speculative block comes back through the
    free list, and the streams stay the cycle."""
    _, cmodel, perm = cyc
    pe = port_engine(cmodel, max_slots=4, block_size=8, max_context=64,
                     num_blocks=10, **SPEC)
    rng = np.random.default_rng(10)
    for wave in range(3):
        # three lanes on the 8-cycle (drafts accepted), one on the long
        # cycle whose history repeats the pair (x, perm[x]) with a
        # continuation the model rejects
        x = int(rng.integers(8, CFG["hidden_size"]))
        reqs = [(chain(perm, s, 20), 16) for s in rng.integers(0, 8, 3)] \
            + [([x, int(perm[x]), x, x], 16)]
        outs = serve(pe, reqs)
        for (p, _), out in zip(reqs[:3], outs):
            assert out == chain(perm, perm[p[-1]], 16)
        a = pe.cache.allocator
        assert a.available() == a.capacity and a.occupancy() == 0.0
    assert pe.scheduler.n_preemptions > 0
    assert pe.n_spec_accepted > 0
    assert pe.n_spec_proposed > pe.n_spec_accepted


def test_spec_verify_fault_falls_back_to_decode(cyc):
    """An injected raise at `generation.spec_verify` costs one round of
    speculation: the drafted lanes roll back and decode, the request
    runs to its length, and the stream is unchanged."""
    _, cmodel, perm = cyc
    prompt = chain(perm, 3, 12)
    want = port_engine(cmodel, **GEOM).generate(prompt, max_new_tokens=12)
    pe = port_engine(cmodel, **GEOM, **SPEC)
    OrcaContext.fault_plan = {"faults": [
        {"site": "generation.spec_verify", "at": 1, "action": "raise"}]}
    try:
        s = pe.submit(prompt, max_new_tokens=12)
        pe.step()
        assert pe.n_verify_steps == 0 and pe.n_decode_steps == 1
        pe.run_until_idle()
    finally:
        OrcaContext.fault_plan = None
    assert s.tokens() == want and s.finish_reason == "length"
    assert pe.n_verify_steps > 0
    assert idle_residency(pe) == (0, 0, 0)


@pytest.mark.parametrize("kv_quantization", [None, "int8"],
                         ids=["f32", "int8"])
def test_all_four_features_together_match_jax(cyc, kv_quantization):
    """Prefix caching, chunked prefill, the host tier and speculation at
    once, with a pool small enough that cached prefixes spill and come
    back: the streams of two waves equal the JAX engine's, and every
    feature did its work."""
    cparams, cmodel, perm = cyc
    rng = np.random.default_rng(11)
    stems = [chain(perm, s, 24) for s in (1, 6)]
    wave = [(stems[i % 2] + chain(perm, int(rng.integers(32)), 3), 12)
            for i in range(4)] + [(list(rng.integers(0, VOCAB, 30)), 10)]
    kw = dict(max_slots=2, block_size=8, max_context=64, num_blocks=12,
              prefix_caching=True, chunked_prefill=True,
              prefill_token_budget=16, kv_host_tier=1 << 20,
              kv_quantization=kv_quantization, **SPEC)
    pe = port_engine(cmodel, **kw)
    je = jax_engine(cparams, **kw)
    for w in (wave, wave[::-1]):
        assert serve(pe, w) == serve(je, w)
    assert pe.n_chunks and pe.n_spec_accepted and pe.prefix_cache.n_hits
    assert pe.n_host_restores == int(je.host_tier._c_restored.value) > 0
    assert pe.host_tier.n_spilled == int(je.host_tier._c_spilled.value)
    held, cached, shared = idle_residency(pe)
    assert held == cached and shared == 0


def test_speculation_defaults_off_and_knobs_plumb(weights):
    _, model = weights
    assert OrcaContext.speculative_decoding is False
    assert OrcaContext.speculative_k == 4
    pe = port_engine(model, **dict(GEOM, speculative_decoding="auto"))
    assert pe.speculation is None
    OrcaContext.speculative_decoding = True
    OrcaContext.speculative_k = 8
    try:
        pe = port_engine(model, **dict(GEOM, speculative_decoding="auto"),
                         speculative_k="auto")
        assert pe.speculation.k == 8 and pe.speculation.buckets == (2, 4, 8)
    finally:
        OrcaContext.speculative_decoding = False
        OrcaContext.speculative_k = 4
