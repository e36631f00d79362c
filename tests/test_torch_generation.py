"""The port's generation engine on its own (analytics_zoo_tpu_torch/
serving/generation/): block allocator invariants, the pool layout,
KV-cached decode against a full-sequence recompute (the JAX package's
own check, tests/test_generation.py), paged vs concat decode, join and
leave mid-stream, request validation and queue shedding, the
background serving loop, and sampling (a distribution check: the
frameworks draw different random numbers from one seed)."""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.serving.generation import (
    BlockAllocator,
    CausalLM,
    GenerationEngine,
    PagedKVCache,
    QueueFull,
    RequestTooLarge,
    sample_tokens,
)

VOCAB = 61
CFG = dict(vocab=VOCAB, hidden_size=32, n_head=4, n_block=2,
           intermediate_size=64, max_position_len=256)


@pytest.fixture(scope="module")
def model():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    return CausalLM(**CFG, device="cpu").eval()


def _engine(model, **kw):
    geom = dict(max_slots=4, block_size=8, max_context=64)
    geom.update(kw)
    return GenerationEngine(model, device="cpu", **geom)


def _assert_greedy(model, prompt, out):
    """Greedy decoding == teacher forcing: on the completed sequence
    every generated token is the argmax of the full recompute's logits
    at its preceding position."""
    assert out, "no tokens generated"
    seq = list(prompt) + list(out)
    with torch.no_grad():
        logits, _, _ = model(torch.tensor([seq]),
                             torch.arange(len(seq))[None],
                             token_mask=torch.ones(1, len(seq)))
    want = logits[0].argmax(-1).numpy()
    for i, tok in enumerate(out):
        assert tok == want[len(prompt) + i - 1], (
            f"token {i}: engine {tok} != full recompute "
            f"{want[len(prompt) + i - 1]}")


def test_block_allocator_invariants():
    a = BlockAllocator(8)               # 7 allocatable, block 0 null
    assert a.capacity == 7
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert a.available() == 4
    assert abs(a.occupancy() - 3 / 7) < 1e-9
    assert a.alloc(5) is None           # over-ask: nothing handed out
    assert a.available() == 4
    rest = a.alloc(4)
    assert a.alloc(1) is None and a.occupancy() == 1.0
    a.share(rest[:1])
    assert a.ref_count(rest[0]) == 2
    a.free(got)
    with pytest.raises(ValueError, match="double free"):
        a.free([got[0]])
    with pytest.raises(ValueError, match="null block"):
        a.free([0])
    with pytest.raises(ValueError, match="out of range"):
        a.free([99])
    with pytest.raises(ValueError, match="cannot share"):
        a.share([got[0]])
    # a duplicate id within one call past its references is a double
    # free, and the rejected call leaves the pool untouched
    with pytest.raises(ValueError, match="double free"):
        a.free([rest[1], rest[1]])
    assert a.ref_count(rest[1]) == 1
    a.free(rest + rest[:1])
    assert a.available() == 7 and a.occupancy() == 0.0


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_paged_cache_layout(quantization):
    c = PagedKVCache(n_layers=2, num_blocks=5, block_size=4, n_head=2,
                     head_dim=8, quantization=quantization, device="cpu")
    assert c.kv.shape == (2, 2, 20, 2, 8)
    assert c.blocks_for(1) == 1 and c.blocks_for(4) == 1
    assert c.blocks_for(5) == 2
    assert c.logical_nbytes == 2 * 2 * 20 * 2 * 8 * 4
    if quantization:
        assert c.kv.dtype == torch.int8
        assert c.kv_scale.shape == (2, 2, 20)
        assert c.physical_nbytes == 2 * 2 * 20 * (2 * 8 + 4)
    else:
        assert c.kv_scale is None
        assert c.physical_nbytes == c.logical_nbytes
    with pytest.raises(ValueError, match="unsupported KV quantization"):
        PagedKVCache(1, 2, 4, 1, 8, quantization="fp8", device="cpu")


def test_cached_decode_matches_full_recompute(model):
    eng = _engine(model)
    eng.warmup()
    rng = np.random.default_rng(2)
    total = 0
    for _ in range(3):
        prompt = rng.integers(0, VOCAB, int(rng.integers(4, 20))).tolist()
        out = eng.generate(prompt, max_new_tokens=int(rng.integers(3, 12)))
        _assert_greedy(model, prompt, out)
        total += len(out)
    # one request at a time: its first token comes from the prefill,
    # each later one from a decode step; every block is back at the end
    assert eng.cache.allocator.occupancy() == 0.0
    assert eng.n_requests == 3 and eng.n_prefills == 3
    assert eng.n_tokens == total
    assert eng.n_decode_steps == total - 3


@pytest.mark.parametrize("kv_quantization", [None, "int8"])
def test_paged_and_concat_decode_identical(model, kv_quantization):
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, VOCAB, int(n)).tolist()
            for n in rng.integers(3, 40, 6)]
    outs = {}
    for mode in ("paged", "concat"):
        eng = _engine(model, decode_attention=mode,
                      kv_quantization=kv_quantization)
        streams = [eng.submit(p, max_new_tokens=9) for p in reqs]
        eng.run_until_idle()
        outs[mode] = [s.tokens() for s in streams]
    assert outs["paged"] == outs["concat"]
    if kv_quantization is None:
        for p, out in zip(reqs, outs["paged"]):
            _assert_greedy(model, p, out)


def test_keep_logits_records_the_sampled_rows(model):
    eng = _engine(model, keep_logits=True)
    prompt = [5, 9, 2, 44, 17]
    s = eng.submit(prompt, max_new_tokens=6)
    eng.run_until_idle()
    out = s.tokens()
    seq = prompt + out
    with torch.no_grad():
        full, _, _ = model(torch.tensor([seq]), torch.arange(len(seq))[None],
                           token_mask=torch.ones(1, len(seq)))
    got = torch.stack(s.seq.logits)
    assert got.shape == (6, VOCAB)
    torch.testing.assert_close(got, full[0, len(prompt) - 1:-1],
                               atol=1e-4, rtol=0)


def test_join_and_leave_midstream(model):
    eng = _engine(model, max_slots=2)
    rng = np.random.default_rng(4)
    p_long = rng.integers(0, VOCAB, 10).tolist()
    p_short = rng.integers(0, VOCAB, 6).tolist()
    long_s = eng.submit(p_long, max_new_tokens=20)
    eng.step()
    assert long_s.seq.status == "running"
    short_s = eng.submit(p_short, max_new_tokens=3)
    eng.step()
    assert short_s.seq.status == "running"
    assert len(eng.scheduler.running()) == 2
    while short_s.seq.status == "running":
        eng.step()
    assert short_s.seq.finish_reason == "length"
    assert long_s.seq.status == "running"
    third = eng.submit(p_short, max_new_tokens=2)
    eng.step()
    assert third.seq.status in ("running", "finished")
    eng.run_until_idle()
    _assert_greedy(model, p_long, long_s.tokens())
    _assert_greedy(model, p_short, short_s.tokens())
    assert len(long_s.seq.generated) == 20


def test_priority_admits_first(model):
    eng = _engine(model, max_slots=1)
    low = eng.submit([1, 2, 3], max_new_tokens=2, priority=2)
    high = eng.submit([4, 5, 6], max_new_tokens=2, priority=0)
    assert list(eng.scheduler.waiting) == [high.seq, low.seq]
    eng.run_until_idle()
    assert low.tokens() and high.tokens()


def test_submit_validation_and_queue_bound(model):
    eng = _engine(model, max_slots=2, max_context=32, max_queue=2)
    with pytest.raises(RequestTooLarge, match="max_context"):
        eng.submit(list(range(30)), max_new_tokens=10)
    with pytest.raises(ValueError, match="vocab"):
        eng.submit([VOCAB + 5], max_new_tokens=1)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new_tokens=1)
    small = _engine(model, max_context=64, num_blocks=3)
    with pytest.raises(RequestTooLarge, match="KV blocks"):
        small.submit(list(range(20)), max_new_tokens=10)
    eng.submit([1], max_new_tokens=1)
    eng.submit([2], max_new_tokens=1)
    with pytest.raises(QueueFull) as info:
        eng.submit([3], max_new_tokens=1)
    assert info.value.retry_after_s > 0
    eng.run_until_idle()
    with pytest.raises(ValueError, match="max_position_len"):
        _engine(model, max_context=512)
    with pytest.raises(ValueError, match="decode_attention"):
        _engine(model, decode_attention="flash")


def test_background_loop_serves_and_stops(model):
    eng = _engine(model).ensure_started()
    try:
        streams = [eng.submit([7, 8, 9, i], max_new_tokens=5)
                   for i in range(6)]
        outs = [s.tokens() for s in streams]
    finally:
        eng.stop()
    assert all(len(o) == 5 for o in outs)
    assert all(s.finish_reason == "length" for s in streams)
    assert eng._thread is None
    # requests left over at stop() are closed, not left hanging
    pending = eng.submit([1, 2], max_new_tokens=3)
    eng.stop()
    assert pending.tokens() == []
    assert pending.finish_reason == "error: engine stopped"


def test_sampling_greedy_and_top_k_support():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    greedy = logits.argmax(-1).to(torch.int32)
    t0 = sample_tokens(logits, gen, torch.zeros(3),
                       torch.zeros(3, dtype=torch.int32))
    assert t0.dtype == torch.int32 and torch.equal(t0, greedy)
    k1 = sample_tokens(logits, gen, torch.full((3,), 2.0),
                       torch.ones(3, dtype=torch.int32))
    assert torch.equal(k1, greedy)
    # ties: argmax takes the first maximal index, as jnp.argmax does
    tie = torch.tensor([[0.0, 3.0, 3.0, 1.0]])
    assert int(sample_tokens(tie, gen, torch.zeros(1),
                             torch.zeros(1, dtype=torch.int32))) == 1


def test_sampling_distribution_fixed_seed():
    """top_k=4 at temperature 1.5: every draw lies in the top 4, and the
    frequencies of 4000 draws match softmax(top-4 logits / 1.5) within
    4 standard errors."""
    logits = torch.tensor([[2.0, -1.0, 0.5, 1.5, -3.0, 1.0, 0.0, -0.5]])
    n = 4000
    gen = torch.Generator().manual_seed(1234)
    draws = torch.cat([sample_tokens(logits, gen, torch.full((1,), 1.5),
                                     torch.full((1,), 4, dtype=torch.int32))
                       for _ in range(n)]).numpy()
    top4 = torch.topk(logits[0], 4).indices.numpy()
    assert np.isin(draws, top4).all()
    p = torch.softmax(logits[0, top4] / 1.5, -1).numpy()
    freq = np.array([(draws == t).mean() for t in top4])
    assert (np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / n)).all()
