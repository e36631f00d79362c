"""Shared scenes of the generation-engine parity tests
(tests/test_torch_prefix_cache.py, test_torch_chunked_prefill.py,
test_torch_host_tier.py, test_torch_speculation.py): one small
`CausalLM` initialised by JAX and converted into the port, a wired
"cycle" variant of its weights, engines of both packages built with the
same geometry and features, and the greedy teacher-forcing check."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.observability.registry import MetricsRegistry
from analytics_zoo_tpu.serving.generation import (
    CausalLM as JaxCausalLM,
    GenerationEngine as JaxEngine,
)
from analytics_zoo_tpu_torch.convert import causal_lm_from_flax
from analytics_zoo_tpu_torch.serving.generation import (
    CausalLM,
    GenerationEngine,
)

VOCAB = 61
CFG = dict(vocab=VOCAB, hidden_size=32, n_head=4, n_block=2,
           intermediate_size=64, max_position_len=256)
#: every feature named, so neither engine reads its OrcaContext
OFF = dict(prefix_caching=False, chunked_prefill=False,
           speculative_decoding=False, kv_host_tier=0)


def jax_params(seed: int = 0):
    torch.backends.cuda.matmul.allow_tf32 = False
    return JaxCausalLM(**CFG).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jnp.arange(8)[None])["params"]


def cycle_params(params, perm):
    """Zero every block's output projection and fc2 (identity residual),
    zero the position table, embed token t as the one-hot at dim t and
    map dim t to perm[t] in the head (weight 10): greedy decoding walks
    `perm` at every position whatever the context (bench.py's
    `_cycle_lm` wiring; needs hidden_size >= the tokens it embeds)."""
    p = jax.tree_util.tree_map(np.array, params)
    for b in range(CFG["n_block"]):
        for name in (f"block_{b}_proj", f"block_{b}_fc2"):
            p[name]["kernel"][...] = 0
            p[name]["bias"][...] = 0
    p["position_embed"]["embedding"][...] = 0
    emb = np.zeros_like(p["token_embed"]["embedding"])
    head = np.zeros_like(p["lm_head"]["kernel"])
    for t in range(CFG["hidden_size"]):
        emb[t, t] = 1.0
        head[t, perm[t]] = 10.0
    p["token_embed"]["embedding"] = emb
    p["lm_head"]["kernel"] = head
    p["lm_head"]["bias"][...] = 0
    return jax.tree_util.tree_map(jnp.asarray, p)


def cycle_perm(seed: int = 0, cycle_len: int = 8):
    """bench.py's wiring over the first hidden_size tokens (the ones the
    cycle model embeds): tokens 0..cycle_len-1 in one short cycle,
    the rest in one long cycle in a random order."""
    n = CFG["hidden_size"]
    rest = np.random.default_rng(seed).permutation(np.arange(cycle_len, n))
    perm = np.empty(n, dtype=np.int64)
    for i in range(cycle_len):
        perm[i] = (i + 1) % cycle_len
    for i, t in enumerate(rest):
        perm[t] = rest[(i + 1) % len(rest)]
    return perm


def chain(perm, start, n):
    out = [int(start)]
    for _ in range(n - 1):
        out.append(int(perm[out[-1]]))
    return out


def port_model(params):
    m = CausalLM(**CFG, device="cpu")
    m.load_state_dict(causal_lm_from_flax(
        jax.tree_util.tree_map(np.asarray, params), CFG))
    return m.eval()


def jax_engine(params, **kw):
    kw = dict(OFF, **kw)
    if "cache_dtype" in kw and kw["cache_dtype"] is torch.float16:
        kw["cache_dtype"] = jnp.float16
    kw.setdefault("kv_quantization", None)
    return JaxEngine(JaxCausalLM(**CFG), params, tensor_parallel=0,
                     registry=MetricsRegistry(), **kw)


def port_engine(model, **kw):
    kw = dict(OFF, **kw)
    kw.setdefault("kv_quantization", None)
    return GenerationEngine(model, device="cpu", **kw)


def serve(engine, reqs):
    """Submit every (prompt, max_new_tokens), drain, return the
    streams' tokens."""
    streams = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
    engine.run_until_idle()
    return [s.tokens() for s in streams]


def assert_greedy(model, prompt, out):
    """Greedy decoding == teacher forcing: each generated token is the
    argmax of the port model's full recompute at its preceding
    position."""
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


def idle_residency(engine):
    """(blocks held, blocks the prefix tree holds, blocks shared) of an
    idle engine: equal first two and no sharing = no leaked lane
    reference."""
    a = engine.cache.allocator
    cached = engine.prefix_cache.n_blocks if engine.prefix_cache else 0
    return a.capacity - a.available(), cached, a.n_shared()
