"""The slice as a whole: the JAX `GenerationEngine` and the port's
`GenerationEngine(device="cpu")` serve the same greedy requests on the
same weights (a JAX `init` tree converted by
analytics_zoo_tpu_torch/convert.py) and must give IDENTICAL token
streams — several concurrent requests of mixed lengths, and a run whose
block pool is small enough to force preemption (recompute-on-resume),
for the f32 and the int8 KV pool."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.serving.generation import (
    CausalLM as JaxCausalLM,
    GenerationEngine as JaxEngine,
)
from analytics_zoo_tpu_torch.convert import causal_lm_from_flax
from analytics_zoo_tpu_torch.serving.generation import (
    CausalLM,
    GenerationEngine,
)

CFG = dict(vocab=61, hidden_size=32, n_head=4, n_block=2,
           intermediate_size=64, max_position_len=128)


@pytest.fixture(scope="module")
def weights():
    torch.backends.cuda.matmul.allow_tf32 = False
    params = JaxCausalLM(**CFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.arange(8)[None])["params"]
    return params, causal_lm_from_flax(
        jax.tree_util.tree_map(np.asarray, params), CFG)


def _requests(seed, n, lo, hi, new):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG["vocab"], int(rng.integers(lo, hi)))
             .tolist(), new) for _ in range(n)]


def _serve_jax(params, reqs, kv_quantization, **geom):
    eng = JaxEngine(JaxCausalLM(**CFG), params,
                    kv_quantization=kv_quantization, prefix_caching=False,
                    chunked_prefill=False, tensor_parallel=0,
                    speculative_decoding=False, kv_host_tier=0, **geom)
    streams = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    eng.run_until_idle()
    return [s.tokens() for s in streams], eng.scheduler.n_preemptions


def _serve_port(state, reqs, kv_quantization, **geom):
    model = CausalLM(**CFG, device="cpu")
    model.load_state_dict(state)
    eng = GenerationEngine(model, kv_quantization=kv_quantization,
                           device="cpu", **geom)
    streams = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    eng.run_until_idle()
    assert eng.cache.allocator.occupancy() == 0.0
    return [s.tokens() for s in streams], eng.scheduler.n_preemptions


@pytest.mark.parametrize("kv_quantization", [None, "int8"],
                         ids=["f32", "int8"])
def test_concurrent_mixed_lengths_identical_streams(weights,
                                                    kv_quantization):
    params, state = weights
    reqs = _requests(1, 6, 3, 40, 10)
    geom = dict(max_slots=4, block_size=8, max_context=64)
    want, _ = _serve_jax(params, reqs, kv_quantization, **geom)
    got, _ = _serve_port(state, reqs, kv_quantization, **geom)
    assert all(len(t) == 10 for t in got)
    assert got == want


@pytest.mark.parametrize("kv_quantization", [None, "int8"],
                         ids=["f32", "int8"])
def test_preemption_identical_streams(weights, kv_quantization):
    """9 allocatable blocks for 4 lanes that each grow to 5: the pool
    runs dry mid-decode, lanes are preempted newest-first and resume by
    re-prefilling — and both engines still agree token for token."""
    params, state = weights
    reqs = _requests(2, 5, 18, 22, 16)
    geom = dict(max_slots=4, block_size=8, max_context=64, num_blocks=10)
    want, jax_pre = _serve_jax(params, reqs, kv_quantization, **geom)
    got, port_pre = _serve_port(state, reqs, kv_quantization, **geom)
    assert port_pre > 0 and port_pre == jax_pre
    assert all(len(t) == 16 for t in got)
    assert got == want
