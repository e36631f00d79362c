"""Weights between the JAX package's flax layout and the port's modules.

`causal_lm_from_flax` turns a flax `CausalLM` param tree (numpy arrays,
keyed as the JAX module names them) into a `state_dict` for the port's
`CausalLM`: a Dense `kernel [in, out]` becomes a Linear `weight
[out, in]`, a LayerNorm `scale` becomes `weight`, an Embed `embedding`
becomes `weight`.  `init_causal_lm_params` builds such a tree from a
seed with numpy alone — the same structure and shapes as the JAX
module's `init`, so a machine without JAX can make random weights in
the reference's layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_DENSES = ("qkv", "proj", "fc1", "fc2")
_NORMS = ("ln1", "ln2")


def _dense_shapes(config: Mapping) -> Dict[str, tuple]:
    h, m = config["hidden_size"], config["intermediate_size"]
    return {"qkv": (h, 3 * h), "proj": (h, h), "fc1": (h, m),
            "fc2": (m, h)}


def causal_lm_from_flax(params: Mapping, config: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """The port's `CausalLM` state_dict from a flax param tree.
    `config` holds the constructor fields (vocab, hidden_size, n_head,
    n_block, intermediate_size, max_position_len).  Raises on a missing
    or unknown entry and on a shape that disagrees with `config`."""
    n_block = config["n_block"]
    hid = config["hidden_size"]
    dense = _dense_shapes(config)
    out: Dict[str, np.ndarray] = {}
    seen = set()

    def take(name, leaf, shape):
        arr = np.asarray(params[name][leaf])
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name}/{leaf} has shape {arr.shape}, "
                             f"config says {tuple(shape)}")
        seen.add(name)
        return arr

    out["token_embed.weight"] = take(
        "token_embed", "embedding", (config["vocab"], hid))
    out["position_embed.weight"] = take(
        "position_embed", "embedding", (config["max_position_len"], hid))
    out["embed_ln.weight"] = take("embed_ln", "scale", (hid,))
    out["embed_ln.bias"] = take("embed_ln", "bias", (hid,))
    for i in range(n_block):
        for d in _DENSES:
            src = f"block_{i}_{d}"
            fan_in, fan_out = dense[d]
            out[f"blocks.{i}.{d}.weight"] = take(
                src, "kernel", (fan_in, fan_out)).T
            out[f"blocks.{i}.{d}.bias"] = take(src, "bias", (fan_out,))
        for n in _NORMS:
            src = f"block_{i}_{n}"
            out[f"blocks.{i}.{n}.weight"] = take(src, "scale", (hid,))
            out[f"blocks.{i}.{n}.bias"] = take(src, "bias", (hid,))
    out["lm_head.weight"] = take("lm_head", "kernel",
                                 (hid, config["vocab"])).T
    out["lm_head.bias"] = take("lm_head", "bias", (config["vocab"],))
    unknown = set(params) - seen
    if unknown:
        raise ValueError(f"unknown entries in the param tree: "
                         f"{sorted(unknown)}")
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in out.items()}


def init_causal_lm_params(config: Mapping, seed: int = 0
                          ) -> Dict[str, Dict[str, np.ndarray]]:
    """Random f32 weights in the flax `CausalLM` layout, from `seed`:
    embeddings ~ N(0, 1/hidden), Dense kernels ~ N(0, 1/fan_in) with
    zero biases, LayerNorm scale ones and bias zeros."""
    rng = np.random.default_rng(seed)
    hid = config["hidden_size"]

    def normal(shape, fan):
        return rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(1.0 / np.sqrt(fan))

    def dense(fan_in, fan_out):
        return {"kernel": normal((fan_in, fan_out), fan_in),
                "bias": np.zeros(fan_out, np.float32)}

    def norm():
        return {"scale": np.ones(hid, np.float32),
                "bias": np.zeros(hid, np.float32)}

    tree = {"token_embed": {"embedding": normal((config["vocab"], hid),
                                                hid)},
            "position_embed": {"embedding": normal(
                (config["max_position_len"], hid), hid)},
            "embed_ln": norm()}
    for i in range(config["n_block"]):
        for d, (fan_in, fan_out) in _dense_shapes(config).items():
            tree[f"block_{i}_{d}"] = dense(fan_in, fan_out)
        for n in _NORMS:
            tree[f"block_{i}_{n}"] = norm()
    tree["lm_head"] = dense(hid, config["vocab"])
    return tree
