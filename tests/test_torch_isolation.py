"""The port stands alone: `analytics_zoo_tpu_torch` and chip_smoke.py
import neither `jax` nor anything of the JAX package `analytics_zoo_tpu`
(checked in a fresh interpreter, since this test process already holds
jax, and by a static scan of the sources), and an entry point given no
device on a machine without CUDA raises instead of running on the
CPU."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "analytics_zoo_tpu_torch")

#: an import of jax or of the JAX package, written as a statement or
#: through importlib/__import__ (never matches analytics_zoo_tpu_torch)
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|analytics_zoo_tpu)(?:\.|\s|$)"
    r"|(?:import_module|__import__)\(\s*['\"](?:jax|analytics_zoo_tpu)"
    r"(?:\.|['\"])", re.M)

_CHILD = r"""
import importlib, pkgutil, sys
import analytics_zoo_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."):
    importlib.import_module(info.name)
import torch
from analytics_zoo_tpu_torch.serving.generation import (
    CausalLM, GenerationEngine)
from analytics_zoo_tpu_torch.convert import (
    causal_lm_from_flax, init_causal_lm_params)
cfg = dict(vocab=31, hidden_size=16, n_head=2, n_block=1,
           intermediate_size=32, max_position_len=64)
m = CausalLM(**cfg, device="cpu")
m.load_state_dict(causal_lm_from_flax(init_causal_lm_params(cfg, 0), cfg))
for quant in (None, "int8"):
    eng = GenerationEngine(m, max_slots=2, block_size=4, max_context=32,
                           kv_quantization=quant, device="cpu")
    assert len(eng.generate([1, 2, 3], max_new_tokens=4)) == 4
import numpy as np
from analytics_zoo_tpu_torch.convert import bert_from_flax, init_bert_params
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel
bcfg = dict(vocab=31, hidden_size=32, n_head=2, n_block=1,
            intermediate_size=64, max_position_len=16, num_classes=2)
for impl in ("einsum", "flash"):
    bm = BERTClassifier(**bcfg, attn_impl=impl, device="cpu")
    bm.load_state_dict(bert_from_flax(init_bert_params(bcfg, 0), bcfg))
    out = InferenceModel(max_batch_size=2).load_module(bm).predict(
        np.ones((3, 8), np.int32), np.zeros((3, 8), np.int32),
        np.ones((3, 8), np.int32))
    assert out.shape == (3, 2)
from analytics_zoo_tpu_torch.orca.learn import Estimator
bm = BERTClassifier(**bcfg, attn_impl="flash", device="cpu")
est = Estimator.from_torch(bm, learning_rate=1e-3).fit(
    {"x": [np.ones((6, 8), np.int32), np.zeros((6, 8), np.int32),
           np.ones((6, 8), np.int32)], "y": np.arange(6) % 2}, batch_size=4)
assert est.engine.host_step == 2 and "accuracy" in est.train_summary[-1]
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "flax"
             or n == "analytics_zoo_tpu"
             or n.startswith("analytics_zoo_tpu."))
print("FORBIDDEN", bad)
"""


def _sources():
    for root, _dirs, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_fresh_interpreter_never_loads_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_static_scan_of_port_and_chip_smoke():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from analytics_zoo_tpu.ops import x")
    assert _FORBIDDEN.search("importlib.import_module('analytics_zoo_tpu')")
    assert not _FORBIDDEN.search("from analytics_zoo_tpu_torch.ops import x")
    assert not _FORBIDDEN.search("import analytics_zoo_tpu_torch")
    n = 0
    for path in _sources():
        with open(path) as fh:
            src = fh.read()
        n += 1
        hit = _FORBIDDEN.search(src)
        assert hit is None, f"{path}: {hit.group(0)!r}"
        for node in ast.walk(ast.parse(src, path)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "flax", "analytics_zoo_tpu"), \
                    f"{path} imports {name}"
    assert n >= 22


def test_no_device_and_no_cuda_raises(monkeypatch):
    from analytics_zoo_tpu_torch import resolve_device
    from analytics_zoo_tpu_torch.serving.generation import (
        CausalLM,
        GenerationEngine,
        PagedKVCache,
    )
    model = CausalLM(vocab=31, hidden_size=16, n_head=2, n_block=1,
                     intermediate_size=32, max_position_len=64,
                     device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(model, max_slots=2, block_size=4, max_context=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalLM(vocab=31, hidden_size=16, n_head=2, n_block=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(1, 4, 4, 2, 8)
    assert resolve_device("cpu") == torch.device("cpu")
