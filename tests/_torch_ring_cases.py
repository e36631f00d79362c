"""The ranks of the port's ring-attention tests: two gloo processes that
`tests/test_torch_ring_attention.py` spawns once per module and feeds
cases over a pipe.  This module imports torch and the port, never JAX:
the spawned interpreters import it by name."""

import importlib
import os
import socket

import numpy as np
import torch

#: the ring's ranks in the tests
WORLD = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _t(a, grad=False):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(grad) if grad else t


def run_attention(case):
    """`ring_self_attention` forward and backward on the case's global
    numpy arrays: the output, the gradients of sum(out * w) and the
    impl the ring ran."""
    ra = importlib.import_module(
        "analytics_zoo_tpu_torch.parallel.ring_attention")
    seen = []
    real = ra._ring

    def spy(*args):
        seen.append(args[6])
        return real(*args)

    ra._ring = spy
    prev = ra.RING_FLASH_MIN_TLOCAL
    ra.RING_FLASH_MIN_TLOCAL = case.get("min_tlocal", prev)
    try:
        q, k, v = (_t(case[n], True) for n in "qkv")
        bias = _t(case.get("bias"), True)
        out = ra.ring_self_attention(
            q, k, v, causal=case.get("causal", False),
            kv_mask=_t(case.get("kv_mask")), impl=case.get("impl", "einsum"),
            bias=bias, dropout_rate=case.get("dropout_rate", 0.0),
            dropout_rng=case.get("seed"))
        (out * _t(case["w"])).sum().backward()
    finally:
        ra._ring = real
        ra.RING_FLASH_MIN_TLOCAL = prev
    res = {"out": out.detach().numpy(), "dq": q.grad.numpy(),
           "dk": k.grad.numpy(), "dv": v.grad.numpy(),
           "impl": seen[-1] if seen else None}
    if bias is not None:
        res["dbias"] = bias.grad.numpy()
    return res


def run_keras(case):
    """The port's `MultiHeadAttention(attn_impl="ring")` on the case's
    weights (a state_dict of numpy arrays): its output and the input's
    and every weight's gradient of sum(out * w)."""
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        MultiHeadAttention,
    )

    hid, heads = case["hidden"], case["heads"]
    layer = MultiHeadAttention(hid, heads, causal=case["causal"],
                               compute_dtype=torch.float32,
                               attn_impl="ring", device="cpu")
    layer.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["state"].items()})
    layer.eval()
    x = _t(case["x"], True)
    out = layer(x, mask=_t(case.get("mask")))
    (out * _t(case["w"])).sum().backward()
    res = {"out": out.detach().numpy(), "dx": x.grad.numpy()}
    res.update({f"d{n}": p.grad.numpy() for n, p in layer.named_parameters()})
    return res


RUNNERS = {"attention": run_attention, "keras": run_keras}


def worker(rank: int, port: int, conn) -> None:
    """One rank: join the group, then answer cases until None."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    from analytics_zoo_tpu_torch.common.context import (
        init_orca_context,
        stop_orca_context,
    )
    try:
        init_orca_context(cluster_mode="distributed",
                          mesh_shape={"sp": WORLD},
                          coordinator_address=f"localhost:{port}",
                          num_processes=WORLD, process_id=rank,
                          device="cpu")
        conn.send(("ready", None))
        while True:
            case = conn.recv()
            if case is None:
                break
            try:
                conn.send(("ok", RUNNERS[case["runner"]](case)))
            except Exception as e:  # reported to the test, which fails
                conn.send(("error", f"{type(e).__name__}: {e}"))
    finally:
        stop_orca_context()
        conn.close()
