"""The port's dispatch ledger (analytics_zoo_tpu_torch/observability/
profiling.py) held against the JAX package's:

  * `abstract_signature` and `diff_signatures` give the same strings
    for the same arrays, numpy on both sides, jax arrays against torch
    tensors (f32, int32, bool, bf16, nested dicts, lists and tuples,
    Python scalars, None);
  * `CausalLMFlops` (prefill, chunked prefill, decode, verify) and
    `train_step_flops` equal JAX's floats exactly (the same formula);
  * one script of ledgered calls, work records and budgets, under the
    same fake clock, leaves the same snapshot rows, MFU block,
    `over_budget` flags and compile events (ts and callsite aside):
    every number is the clock's or the script's, so the tolerance is 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.context import OrcaContext
from _torch_chronos_cases import one_torch_thread  # noqa: F401
from _torch_observability_cases import FakeClock, patch_clock, reset_planes


@pytest.fixture(autouse=True, scope="module")
def _reset_both_packages():
    reset_planes()
    yield
    reset_planes()


@pytest.fixture(autouse=True)
def _peak():
    saved = OrcaContext.hardware_peak_flops, JaxContext.hardware_peak_flops
    yield
    OrcaContext.hardware_peak_flops, JaxContext.hardware_peak_flops = saved
    reset_planes()


def _numpy_tree(t=6):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 9, (2, t)).astype(np.int32),
            "x": [rng.normal(size=(2, 3)).astype(np.float32), None,
                  (np.ones(4, bool), 3, 0.5, True, "mode")],
            "h": rng.normal(size=(5,)).astype(np.float32)}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, fn) for v in tree)
    if isinstance(tree, np.ndarray):
        return fn(tree)
    return tree


def _with_bf16(tree, jax_side: bool):
    """`tree` with its "h" leaf in bf16 (numpy has no bf16 of its own)."""
    tree = dict(tree)
    tree["h"] = (tree["h"].astype(jnp.bfloat16) if jax_side
                 else tree["h"].to(torch.bfloat16))
    return tree


@pytest.mark.parametrize("t", [6, 7])
def test_signatures_match_jax(t):
    args, names = (_numpy_tree(t), 4), ("batch", "n")
    want = jobs.profiling.abstract_signature(args, names)
    assert obs.profiling.abstract_signature(args, names) == want
    jax_args = (_with_bf16(_to(args[0], jnp.asarray), True), 4)
    port_args = (_with_bf16(_to(args[0], torch.from_numpy), False), 4)
    want = jobs.profiling.abstract_signature(jax_args, names)
    got = obs.profiling.abstract_signature(port_args, names)
    assert got == want
    assert dict(got)["batch['h']"] == ("array", (5,), "bfloat16")
    assert dict(got)["batch['x'][2][0]"] == ("array", (4,), "bool")
    assert obs.profiling._signature_bytes(got) == \
        jobs.profiling._signature_bytes(want)


def test_signature_diffs_match_jax():
    a = obs.profiling.abstract_signature((_numpy_tree(6),), ("batch",))
    b_tree = _numpy_tree(7)
    b_tree["x"][2] = (np.ones(4, bool), 3.0, 0.5, True, "mode")
    del b_tree["h"]
    b_tree["extra"] = np.zeros((1,), np.float32)
    b = obs.profiling.abstract_signature((b_tree,), ("batch",))
    want = jobs.profiling.diff_signatures(a, b)
    assert obs.diff_signatures(a, b) == want
    assert {d["path"] for d in want} == {
        "batch['tokens']", "batch['x'][2][1]", "batch['h']",
        "batch['extra']"}


GPT = dict(vocab=61, hidden_size=32, n_block=2, intermediate_size=64)


def test_flops_models_match_jax():
    got, want = obs.CausalLMFlops(**GPT), jobs.CausalLMFlops(**GPT)
    assert got.matmul_per_token == want.matmul_per_token
    for args in ((17,), (16, 32), (0,)):
        assert got.prefill(*args) == want.prefill(*args)
    for args in ((8, 120.5), (0, 3.0)):
        assert got.decode(*args) == want.decode(*args)
    for args in ((3, 5, 40.25), (0, 5, 1.0)):
        assert got.verify(*args) == want.verify(*args)
    for train in (True, False):
        assert obs.train_step_flops(110_000, 4096, train) == \
            jobs.train_step_flops(110_000, 4096, train)


class _Model:
    vocab, hidden_size, n_block, intermediate_size = 61, 32, 2, 64


def test_flops_from_model_reads_the_widths():
    assert obs.CausalLMFlops.from_model(_Model()).matmul_per_token == \
        jobs.CausalLMFlops(**GPT).matmul_per_token


def _ledger_script(o, ctx, clock, arrays):
    reset_planes()
    ctx.hardware_peak_flops = 2.0e9
    o.profiling.declare_expected("decode", 1)
    o.profiling.declare_expected("prefill", 2)

    def step(tokens, lengths):
        clock.tick(0.5)
        return tokens

    decode = o.instrument("decode", step, argnames=("tokens", "lengths"))
    prefill = o.instrument("prefill", step, argnames=("tokens", "lengths"))
    for i in range(4):
        decode(arrays(np.zeros(8, np.int32)), arrays(np.ones(8, np.int32)))
        o.record_work("decode", 0.25, tokens=8, flops=1.0e9)
    for t in (16, 32, 64):
        prefill(arrays(np.zeros((1, t), np.int32)), t)
        o.record_work("prefill", 0.125, tokens=t, flops=3.0e8 * t / 16)
    o.record_work("train_step", 1.0, tokens=32,
                  flops=o.train_step_flops(1000, 32))
    return (o.ledger_snapshot(), o.compile_events(),
            o.profiling.registered_families())


def _strip(snap):
    snap = dict(snap)
    snap.pop("compile_events")
    fams = {}
    for name, row in snap["families"].items():
        row = dict(row)
        last = row.pop("last_compile", None)
        if last is not None:
            last = {k: v for k, v in last.items()
                    if k not in ("ts", "callsite")}
        fams[name] = (row, last)
    snap["families"] = fams
    return snap


def test_ledger_script_matches_jax():
    clock = FakeClock()
    with patch_clock(clock):
        want = _ledger_script(jobs, JaxContext, clock, jnp.asarray)
        got = _ledger_script(obs, OrcaContext, clock, torch.from_numpy)
    assert _strip(got[0]) == _strip(want[0])
    fams = got[0]["families"]
    assert fams["decode"]["calls"] == 4 and fams["decode"]["signatures"] == 1
    assert not fams["decode"]["over_budget"]
    assert fams["prefill"]["over_budget"]        # 3 signatures, budget 2
    assert fams["prefill"]["compile_seconds"] == 1.5
    assert got[0]["mfu"]["decode"] == pytest.approx(2.0, abs=0)
    assert [{k: v for k, v in e.items() if k not in ("ts", "callsite")}
            for e in got[1]] == \
        [{k: v for k, v in e.items() if k not in ("ts", "callsite")}
         for e in want[1]]
    assert got[1][-1]["diff"] == [{"path": "tokens", "old": "int32[1,32]",
                                   "new": "int32[1,64]"}]
    assert got[2] == want[2]
    with pytest.raises(ValueError, match="unknown dispatch family"):
        obs.record_work("generate", 1.0)
    assert obs.DISPATCH_FAMILIES == jobs.DISPATCH_FAMILIES
    assert obs.profiling.DEFAULT_PEAK_FLOPS == \
        jobs.profiling.DEFAULT_PEAK_FLOPS


def test_a_first_dispatch_is_per_wrapper():
    """`last_call_new` is the wrapper's own first dispatch of a
    signature (a second owner's first step at known shapes is cold, as
    a new jitted entry point's is), while the family's compile events
    stay one per signature; a wrapper with no family keeps the flag and
    writes nothing to the ledger."""
    reset_planes()
    batch = {"x": torch.zeros(2, 3)}
    first, second = (obs.instrument("train_step", lambda b: b,
                                    argnames=("batch",)) for _ in range(2))
    bare = obs.instrument(None, lambda b: b)
    flags = []
    for fn in (first, first, second, second, bare, bare):
        fn(batch)
        flags.append(fn.last_call_new)
    assert flags == [True, False, True, False, True, False]
    first({"x": torch.zeros(4, 3)})
    assert first.last_call_new
    rows = obs.ledger_snapshot()["families"]
    assert list(rows) == ["train_step"]
    assert rows["train_step"]["calls"] == 5
    assert rows["train_step"]["compile_count"] == 2
    assert obs.profiling.registered_families() == ("train_step",)
