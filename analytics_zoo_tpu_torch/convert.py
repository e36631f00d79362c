"""Weights between the JAX package's flax layout and the port's modules.

`causal_lm_from_flax` turns a flax `CausalLM` param tree (numpy arrays,
keyed as the JAX module names them) into a `state_dict` for the port's
`CausalLM`: a Dense `kernel [in, out]` becomes a Linear `weight
[out, in]`, a LayerNorm `scale` becomes `weight`, an Embed `embedding`
becomes `weight`.  `init_causal_lm_params` builds such a tree from a
seed with numpy alone — the same structure and shapes as the JAX
module's `init`, so a machine without JAX can make random weights in
the reference's layout.  `bert_from_flax` and `init_bert_params` do
the same for the BERT family (`models/bert.py`), in both of the JAX
encoder's block layouts, and `bert_to_flax` goes back: trained port
weights in the flax tree, to compare with the JAX Estimator's.
`ncf_from_flax`, `wide_and_deep_from_flax` and
`session_recommender_from_flax` do it for the recommendation family
(`models/recommendation/`); its shapes are checked by the module's
`load_state_dict`.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional

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


#: BERT heads by their flax module name, and the config field that
#: gives each one's width (SQuAD's span head is always 2 wide)
_BERT_HEADS = {"classifier": ("num_classes", 2),
               "ner_head": ("num_entities", 9),
               "span_head": (None, 2)}
#: (flax sub-path, port sub-path, `_dense_shapes` key) of each block's
#: dense modules
_BERT_BLOCK = (("attn/qkv", "attn.qkv", "qkv"),
               ("attn/proj", "attn.proj", "proj"),
               ("fc1", "fc1", "fc1"),
               ("fc2", "fc2", "fc2"))


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = np.asarray(v)
    return flat


def bert_from_flax(params: Mapping, config: Mapping
                   ) -> Dict[str, torch.Tensor]:
    """The state_dict of the port's `BERTClassifier`, `BERTNER` or
    `BERTSQuAD` (whichever head the tree holds: `classifier`,
    `ner_head` or `span_head`) from a flax param tree.  Takes both
    block layouts of the JAX `TransformerEncoder`: scan-stacked
    (`bert/blocks/...` with a leading n_block axis, the default) and
    unrolled (`bert/block_{i}/...`).  `config` holds the constructor
    fields (vocab, hidden_size, n_block, intermediate_size,
    max_position_len, and num_classes / num_entities where it sets a
    head's width).  Raises on a missing or unknown entry and on a shape
    that disagrees with `config`."""
    heads = [k for k in params if k in _BERT_HEADS]
    if len(heads) != 1:
        raise ValueError(f"expected one head of {sorted(_BERT_HEADS)} in the "
                         f"param tree, found {heads}")
    head = heads[0]
    flat = _flatten(params)
    hid, n_block = config["hidden_size"], config["n_block"]
    dense = _dense_shapes(config)
    out: Dict[str, np.ndarray] = {}

    def take(path, shape):
        if path not in flat:
            raise ValueError(f"missing {path} in the param tree")
        arr = flat.pop(path)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path} has shape {arr.shape}, config says "
                             f"{tuple(shape)}")
        return arr

    out["bert.token_embed.weight"] = take(
        "bert/token_embed/embedding", (config["vocab"], hid))
    out["bert.position_embed.weight"] = take(
        "bert/position_embed/embedding", (config["max_position_len"], hid))
    out["bert.segment_embed.weight"] = take(
        "bert/segment_embed/embedding", (2, hid))
    out["bert.embed_ln.weight"] = take("bert/embed_ln/scale", (hid,))
    out["bert.embed_ln.bias"] = take("bert/embed_ln/bias", (hid,))

    stacked = any(p.startswith("bert/blocks/") for p in flat)
    leaves = []     # (flax sub-path, port name, per-block shape, transpose)
    for src, dst, key in _BERT_BLOCK:
        fan_in, fan_out = dense[key]
        leaves += [(f"{src}/kernel", f"{dst}.weight", (fan_in, fan_out),
                    True), (f"{src}/bias", f"{dst}.bias", (fan_out,), False)]
    for n in _NORMS:
        leaves += [(f"{n}/scale", f"{n}.weight", (hid,), False),
                   (f"{n}/bias", f"{n}.bias", (hid,), False)]
    for src, dst, shape, transpose in leaves:
        if stacked:
            whole = take(f"bert/blocks/{src}", (n_block, *shape))
            per_block = [whole[i] for i in range(n_block)]
        else:
            per_block = [take(f"bert/block_{i}/{src}", shape)
                         for i in range(n_block)]
        for i, arr in enumerate(per_block):
            out[f"bert.blocks.{i}.{dst}"] = arr.T if transpose else arr

    if head == "classifier":
        out["bert.pooler.weight"] = take("bert/pooler/kernel", (hid, hid)).T
        out["bert.pooler.bias"] = take("bert/pooler/bias", (hid,))
    field, default = _BERT_HEADS[head]
    width = config.get(field, default) if field else default
    out[f"{head}.weight"] = take(f"{head}/kernel", (hid, width)).T
    out[f"{head}.bias"] = take(f"{head}/bias", (width,))
    if flat:
        raise ValueError(f"unknown entries in the param tree: "
                         f"{sorted(flat)}")
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in out.items()}


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


def bert_to_flax(state_dict: Mapping, config: Mapping,
                 stacked: bool = True) -> Dict[str, Dict]:
    """The flax param tree (numpy f32) of the JAX `BERTClassifier`,
    `BERTNER` or `BERTSQuAD` from the state_dict of the port's model
    with the same head: the inverse of `bert_from_flax`.  `stacked`
    gives the scan-stacked block layout (`bert/blocks/...`, the JAX
    default), else the unrolled one (`bert/block_{i}/...`).  Raises on
    a missing or unknown entry and on a shape that disagrees with
    `config`."""
    sd = {k: np.asarray(v.detach().cpu().float() if torch.is_tensor(v)
                        else v, dtype=np.float32)
          for k, v in state_dict.items()}
    heads = [h for h in _BERT_HEADS if f"{h}.weight" in sd]
    if len(heads) != 1:
        raise ValueError(f"expected one head of {sorted(_BERT_HEADS)} in the "
                         f"state_dict, found {heads}")
    head = heads[0]
    hid, n_block = config["hidden_size"], config["n_block"]
    dense = _dense_shapes(config)
    flat: Dict[str, np.ndarray] = {}

    def take(name, shape, transpose=False):
        if name not in sd:
            raise ValueError(f"missing {name} in the state_dict")
        arr = sd.pop(name)
        arr = arr.T if transpose else arr
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {arr.shape} (as flax), "
                             f"config says {tuple(shape)}")
        return np.ascontiguousarray(arr)

    flat["bert/token_embed/embedding"] = take(
        "bert.token_embed.weight", (config["vocab"], hid))
    flat["bert/position_embed/embedding"] = take(
        "bert.position_embed.weight", (config["max_position_len"], hid))
    flat["bert/segment_embed/embedding"] = take(
        "bert.segment_embed.weight", (2, hid))
    flat["bert/embed_ln/scale"] = take("bert.embed_ln.weight", (hid,))
    flat["bert/embed_ln/bias"] = take("bert.embed_ln.bias", (hid,))
    leaves = []     # (flax sub-path, port name, flax shape, transpose)
    for src_, dst, key in _BERT_BLOCK:
        fan_in, fan_out = dense[key]
        leaves += [(f"{src_}/kernel", f"{dst}.weight", (fan_in, fan_out),
                    True), (f"{src_}/bias", f"{dst}.bias", (fan_out,), False)]
    for n in _NORMS:
        leaves += [(f"{n}/scale", f"{n}.weight", (hid,), False),
                   (f"{n}/bias", f"{n}.bias", (hid,), False)]
    for src_, dst, shape, transpose in leaves:
        per_block = [take(f"bert.blocks.{i}.{dst}", shape, transpose)
                     for i in range(n_block)]
        if stacked:
            flat[f"bert/blocks/{src_}"] = np.stack(per_block)
        else:
            for i, arr in enumerate(per_block):
                flat[f"bert/block_{i}/{src_}"] = arr
    if head == "classifier":
        flat["bert/pooler/kernel"] = take("bert.pooler.weight", (hid, hid),
                                          True)
        flat["bert/pooler/bias"] = take("bert.pooler.bias", (hid,))
    field, default = _BERT_HEADS[head]
    width = config.get(field, default) if field else default
    flat[f"{head}/kernel"] = take(f"{head}.weight", (hid, width), True)
    flat[f"{head}/bias"] = take(f"{head}.bias", (width,))
    if sd:
        raise ValueError(f"unknown entries in the state_dict: {sorted(sd)}")
    return _unflatten(flat)


def init_bert_params(config: Mapping, seed: int = 0,
                     head: str = "classifier"
                     ) -> Dict[str, Dict[str, np.ndarray]]:
    """Random f32 weights in the flax layout of the JAX `BERTClassifier`
    (head "classifier"), `BERTNER` ("ner_head") or `BERTSQuAD`
    ("span_head"), from `seed`, with numpy alone: the same tree and
    shapes as the module's `init` (scan-stacked blocks).  Embeddings ~
    N(0, 1/hidden), Dense kernels ~ N(0, 1/fan_in), biases ~ N(0,
    0.02^2) (so a bias path is exercised), LayerNorm scale ones and bias
    zeros."""
    if head not in _BERT_HEADS:
        raise ValueError(f"unknown BERT head {head!r}; one of "
                         f"{sorted(_BERT_HEADS)}")
    rng = np.random.default_rng(seed)
    hid, n_block = config["hidden_size"], config["n_block"]

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def dense(fan_in, fan_out, lead=()):
        return {"kernel": normal((*lead, fan_in, fan_out), fan_in ** -0.5),
                "bias": normal((*lead, fan_out), 0.02)}

    def norm(lead=()):
        return {"scale": np.ones((*lead, hid), np.float32),
                "bias": np.zeros((*lead, hid), np.float32)}

    shapes = _dense_shapes(config)
    lead = (n_block,)
    blocks = {"attn": {"qkv": dense(*shapes["qkv"], lead),
                       "proj": dense(*shapes["proj"], lead)},
              "fc1": dense(*shapes["fc1"], lead),
              "fc2": dense(*shapes["fc2"], lead),
              "ln1": norm(lead), "ln2": norm(lead)}
    bert = {"token_embed": {"embedding": normal((config["vocab"], hid),
                                                hid ** -0.5)},
            "position_embed": {"embedding": normal(
                (config["max_position_len"], hid), hid ** -0.5)},
            "segment_embed": {"embedding": normal((2, hid), hid ** -0.5)},
            "embed_ln": norm(), "blocks": blocks}
    if head == "classifier":
        bert["pooler"] = dense(hid, hid)
    field, default = _BERT_HEADS[head]
    width = config.get(field, default) if field else default
    return {"bert": bert, head: dense(hid, width)}


def _renamed_from_flax(params: Mapping,
                       rename: Callable[[str], Optional[str]]
                       ) -> Dict[str, np.ndarray]:
    """The state_dict entries of a tree of flax Embed and Dense modules:
    module `m` becomes `rename(m)` (None: an unknown entry, raising), an
    `embedding` its `weight`, a `kernel` its transposed `weight`."""
    out = {}
    for path, arr in _flatten(params).items():
        mod, leaf = path.rsplit("/", 1)
        name = rename(mod)
        if name is None or leaf not in ("embedding", "kernel", "bias"):
            raise ValueError(f"unknown entry in the param tree: {path}")
        out[f"{name}.{'bias' if leaf == 'bias' else 'weight'}"] = \
            arr.T if leaf == "kernel" else arr
    return out


def _tensors(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in flat.items()}


def _rename(rules):
    def rename(mod):
        for pattern, repl in rules:
            if re.fullmatch(pattern, mod):
                return re.sub(pattern, repl, mod)
        return None
    return rename


def ncf_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `NeuralCF` state_dict from the JAX module's param tree:
    the four embedding tables by name, the hidden layers' flax auto-names
    `Dense_j` as `hidden.j`, and `head` (its input rows [h; mf])."""
    return _tensors(_renamed_from_flax(params, _rename(
        [(r"(mlp|mf)_(user|item)_embed", r"\g<0>"),
         (r"Dense_(\d+)", r"hidden.\1"), (r"head", "head")])))


def wide_and_deep_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `WideAndDeep` state_dict from the JAX module's param
    tree (`wide_embed_j`, `deep_embed_j`, `deep_fc_j`, `deep_head`)."""
    return _tensors(_renamed_from_flax(params, _rename(
        [(r"(wide_embed|deep_embed|deep_fc)_(\d+)", r"\1.\2"),
         (r"deep_head", "deep_head")])))


def session_recommender_from_flax(params: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """The port's `SessionRecommender` state_dict from the JAX module's
    param tree.  GRU cell j's input Denses ir, iz, in stack into
    `gru.j.weight_ih_l0` and `bias_ih_l0`, its hidden Denses hr, hz, hn
    into `weight_hh_l0`, in torch's (r, z, n) order; `bias_hh_l0` is
    [0, 0, hn.bias] (flax's hr and hz have no bias)."""
    params = dict(params)
    out = {}
    for name in sorted(k for k in params if re.fullmatch(r"gru_cell_\d+", k)):
        cell = _flatten(params.pop(name))
        j = name.rsplit("_", 1)[1]
        known = {f"{g}/{leaf}" for g in ("ir", "iz", "in", "hn")
                 for leaf in ("kernel", "bias")} | {"hr/kernel", "hz/kernel"}
        if set(cell) != known:
            raise ValueError(f"{name}: entries {sorted(cell)}, expected "
                             f"{sorted(known)}")
        hn_b = cell["hn/bias"]
        out[f"gru.{j}.weight_ih_l0"] = np.concatenate(
            [cell[f"i{g}/kernel"].T for g in "rzn"])
        out[f"gru.{j}.weight_hh_l0"] = np.concatenate(
            [cell[f"h{g}/kernel"].T for g in "rzn"])
        out[f"gru.{j}.bias_ih_l0"] = np.concatenate(
            [cell[f"i{g}/bias"] for g in "rzn"])
        out[f"gru.{j}.bias_hh_l0"] = np.concatenate(
            [np.zeros_like(hn_b), np.zeros_like(hn_b), hn_b])
    out.update(_renamed_from_flax(params, _rename(
        [(r"(session|history)_embed", r"\g<0>"),
         (r"mlp_(\d+)", r"mlp.\1"), (r"head", "head")])))
    return _tensors(out)
