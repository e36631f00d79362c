"""The kernel path of the port is differentiable: every CUDA entry point
(`layer_norm_fwd` / `layer_norm_bwd`, `fused_dense_gelu`, `flash_fwd` /
`flash_bwd`) is replaced here by a CPU stand-in that, like the kernels,
returns tensors without autograd history (the plain version under
`torch.no_grad()`), and `impl="kernel"` is routed through them.  Each
parameter of a small BERT must then get the gradient the
`impl="reference"` path gives it, and the backward entry points must be
the ones that computed it.  A kernel whose output had no `grad_fn` (a
forward kernel called outside an autograd Function) leaves the
parameters upstream of it without a gradient, and this test fails.

Tolerance 1e-6 absolute: the stand-ins are the plain versions, so both
paths do the same arithmetic (f32 compute, dropout drawn from one forked
generator state)."""

import numpy as np
import torch

from analytics_zoo_tpu_torch.convert import bert_from_flax, init_bert_params
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.ops import attention, dense, normalization
from analytics_zoo_tpu_torch.ops.kernels import flash_attention as fk
from analytics_zoo_tpu_torch.ops.kernels import fused_dense as dk
from analytics_zoo_tpu_torch.ops.kernels import layer_norm as lk

CFG = dict(vocab=57, hidden_size=64, n_head=2, n_block=2,
           intermediate_size=128, max_position_len=32, num_classes=3)


def _stand_in(plain, calls, name):
    def fn(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        with torch.no_grad():
            return plain(*args, **kwargs)
    return fn


def _grads(model, inputs, labels, impl, gen_state):
    gen = torch.Generator()
    gen.set_state(gen_state)
    model.zero_grad(set_to_none=True)
    logits = model(*inputs, impl=impl, generator=gen)
    torch.nn.functional.cross_entropy(logits, labels).backward()
    return {n: (None if p.grad is None else p.grad.clone())
            for n, p in model.named_parameters()}


def test_kernel_path_gives_every_parameter_its_gradient(monkeypatch):
    calls = {}
    # getattr and raising=False: on a tree without the backward kernels
    # (and their plain versions) the stand-ins are still put in place,
    # so the failure there is the missing gradient, not a missing name
    for mod, name, plain in (
            (normalization, "layer_norm_fwd", lk.layer_norm_fwd_reference),
            (normalization, "layer_norm_bwd",
             getattr(lk, "layer_norm_bwd_reference", None)),
            (dense, "fused_dense_gelu", dk.dense_bias_gelu_reference),
            (attention, "flash_fwd", fk.flash_fwd_reference),
            (attention, "flash_bwd",
             getattr(fk, "flash_bwd_reference", None))):
        monkeypatch.setattr(mod, name, _stand_in(plain, calls, name),
                            raising=False)
    model = BERTClassifier(**CFG, attn_impl="flash",
                           compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(bert_from_flax(init_bert_params(CFG, seed=5), CFG))
    model.train()                     # dropout 0.1 everywhere, one fork
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, CFG["vocab"], (3, 24)))
    seg = torch.zeros_like(ids)
    mask = torch.ones_like(ids)
    mask[1, 15:] = 0
    labels = torch.tensor([0, 2, 1])
    state = torch.Generator().manual_seed(7).get_state()
    want = _grads(model, (ids, seg, mask), labels, "reference", state)
    calls.clear()
    got = _grads(model, (ids, seg, mask), labels, "kernel", state)
    assert all(g is not None for g in want.values())
    missing = sorted(n for n, g in got.items() if g is None)
    assert not missing, f"no gradient through the kernel path: {missing}"
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), atol=1e-6,
                                   rtol=0, err_msg=n)
    n_ln = 2 * CFG["n_block"] + 1
    assert calls == {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
                     "fused_dense_gelu": CFG["n_block"],
                     "flash_fwd": CFG["n_block"],
                     "flash_bwd": CFG["n_block"]}
