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
`load_state_dict`.  `image_from_flax` does it for every image model
(`models/image/`: ResNet, Inception-v1, MobileNetV2, VGG-16, SSD and
Faster R-CNN), whose modules are named as the flax ones: a Conv
`kernel (kh, kw, in, out)` becomes `weight (out, in, kh, kw)`, a
BatchNorm's `scale` its `weight` and its `batch_stats` `mean` / `var`
its `running_mean` / `running_var`.  `text_classifier_from_flax`,
`anomaly_detector_from_flax`, `seq2seq_from_flax`, `knrm_from_flax`
and `vae_from_flax` do it for the rest of the zoo: a flax recurrent cell
becomes its one-layer torch RNN's weights (`models/common/recurrent.py`,
shared with SessionRecommender), a 1-D Conv `kernel (k, in, out)` a
`weight (out, in, k)`.  Each `*_to_flax` is the inverse
of its `*_from_flax` (the flax tree of the port's weights, which
`serving/quantize.py` quantizes as JAX does).  `onnx_from_flax` and
`onnx_to_flax` move an imported ONNX graph's weights
(`pipeline/onnx/`): JAX's `{"params", "batch_stats"}` under the
initializers' safe names, to and from the port's `OnnxModule`.
`tcn_forecaster_from_flax`, `lstm_forecaster_from_flax` and
`seq2seq_forecaster_from_flax` (with their `*_to_flax` inverses) do it
for Chronos's forecaster modules (`chronos/forecaster/`): the flax
params of the JAX forecaster's module (its Estimator's `get_model()`)
to the state_dict of the port's; `mtnet_forecaster_from_flax`,
`tcmf_factorization_from_flax`, `ae_detector_from_flax`,
`dpgan_generator_from_flax` and `dpgan_discriminator_from_flax` (each
with its `*_to_flax`) for the rest of Chronos: MTNet, TCMF's
factorization, the AE detector's autoencoder and the DoppelGANger
simulator's networks.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.common import recurrent

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
    sd = {k: np.array(v.detach().cpu().float() if torch.is_tensor(v)
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


def _kernel_from_flax(arr: np.ndarray) -> np.ndarray:
    """A flax kernel as the port's weight: a Dense's (in, out)
    transposed, a 1-D Conv's (k, in, out) as (out, in, k); each its own
    inverse, so `_renamed_to_flax` takes a weight back through it."""
    return arr.transpose({2: (1, 0), 3: (2, 1, 0)}[arr.ndim])


def _renamed_from_flax(params: Mapping, rules) -> Dict[str, torch.Tensor]:
    """The state_dict of a port model whose flax modules each map to
    one port module by the (pattern, replacement) `rules`: a recurrent
    cell its RNN's weights (`recurrent.cell_from_flax`), an `embedding`
    its `weight`, a kernel its weight (`_kernel_from_flax`).  Raises on
    a module no rule names and on an unknown leaf."""
    rename = _rename(rules)
    out = {}
    for mod, tree in params.items():
        name = rename(mod)
        if name is None or not isinstance(tree, Mapping):
            raise ValueError(f"unknown entry in the param tree: {mod}")
        if recurrent.is_cell(tree):
            weights = recurrent.cell_from_flax(tree, mod)
        else:
            weights = {}
            for leaf, arr in tree.items():
                if leaf not in ("embedding", "kernel", "bias"):
                    raise ValueError(f"unknown entry in the param tree: "
                                     f"{mod}/{leaf}")
                arr = np.asarray(arr)
                weights["bias" if leaf == "bias" else "weight"] = \
                    _kernel_from_flax(arr) if leaf == "kernel" else arr
        out.update({f"{name}.{k}": v for k, v in weights.items()})
    return _tensors(out)


#: the weights of a one-layer torch RNN
_RNN_LEAVES = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


def _renamed_to_flax(state_dict: Mapping, rules) -> Dict:
    """The inverse of `_renamed_from_flax`: each (pattern, flax name,
    is_embedding) rule maps the port modules it matches; an RNN's
    weights become its flax cell (`recurrent.cell_to_flax`), a weight an
    `embedding` or a kernel, a bias a bias."""
    modules: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in state_dict.items():
        mod, leaf = name.rsplit(".", 1)
        modules.setdefault(mod, {})[leaf] = np.array(
            t.detach().cpu().float())
    tree = {}
    for mod, leaves in modules.items():
        rule = next((r for r in rules if re.fullmatch(r[0], mod)), None)
        if rule is None:
            raise ValueError(f"unknown entry in the state_dict: {mod}")
        flax = re.sub(rule[0], rule[1], mod)
        if set(leaves) == set(_RNN_LEAVES):
            tree[flax] = recurrent.cell_to_flax(leaves)
        elif set(leaves) in ({"weight"}, {"weight", "bias"}):
            w = leaves["weight"]
            tree[flax] = {"embedding": w} if rule[2] else {
                "kernel": np.ascontiguousarray(_kernel_from_flax(w))}
            if "bias" in leaves:
                tree[flax]["bias"] = leaves["bias"]
        else:
            raise ValueError(f"unknown entries of {mod}: {sorted(leaves)}")
    return tree


def ncf_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `NeuralCF` state_dict from the JAX module's param tree:
    the four embedding tables by name, the hidden layers' flax auto-names
    `Dense_j` as `hidden.j`, and `head` (its input rows [h; mf])."""
    return _renamed_from_flax(params, [
        (r"(mlp|mf)_(user|item)_embed", r"\g<0>"),
        (r"Dense_(\d+)", r"hidden.\1"), (r"head", "head")])


def ncf_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `NeuralCF` param tree of the port's weights (the inverse
    of `ncf_from_flax`)."""
    return _renamed_to_flax(state_dict, [
        (r"(mlp|mf)_(user|item)_embed", r"\g<0>", True),
        (r"hidden\.(\d+)", r"Dense_\1", False), (r"head", "head", False)])


def wide_and_deep_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `WideAndDeep` state_dict from the JAX module's param
    tree (`wide_embed_j`, `deep_embed_j`, `deep_fc_j`, `deep_head`)."""
    return _renamed_from_flax(params, [
        (r"(wide_embed|deep_embed|deep_fc)_(\d+)", r"\1.\2"),
        (r"deep_head", "deep_head")])


def wide_and_deep_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `WideAndDeep` param tree of the port's weights (the
    inverse of `wide_and_deep_from_flax`)."""
    return _renamed_to_flax(state_dict, [
        (r"(wide_embed|deep_embed)\.(\d+)", r"\1_\2", True),
        (r"deep_fc\.(\d+)", r"deep_fc_\1", False),
        (r"deep_head", "deep_head", False)])


def session_recommender_from_flax(params: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """The port's `SessionRecommender` state_dict from the JAX module's
    param tree: GRU cell j (`gru_cell_j`) as `gru.j`."""
    return _renamed_from_flax(params, [
        (r"gru_cell_(\d+)", r"gru.\1"), (r"(session|history)_embed", r"\g<0>"),
        (r"mlp_(\d+)", r"mlp.\1"), (r"head", "head")])


def session_recommender_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `SessionRecommender` param tree of the port's weights
    (the inverse of `session_recommender_from_flax`)."""
    return _renamed_to_flax(state_dict, [
        (r"gru\.(\d+)", r"gru_cell_\1", False),
        (r"(session|history)_embed", r"\g<0>", True),
        (r"mlp\.(\d+)", r"mlp_\1", False), (r"head", "head", False)])


#: the image models' batch_stats leaves and their buffers
_STATS = {"mean": "running_mean", "var": "running_var"}


def image_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None,
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """The state_dict of a port image model (`models/image/`) from the
    flax `params` and `batch_stats` of its JAX counterpart: module path
    `a/b` becomes `prefix + "a.b"`; a Conv kernel (kh, kw, in, out)
    the weight (out, in, kh, kw), a Dense kernel the transposed weight,
    a BatchNorm scale its weight, mean / var its running_mean /
    running_var.  With `batch_stats` None only the parameters."""
    out = {}
    for path, arr in _flatten(params).items():
        mod, leaf = path.rsplit("/", 1)
        name = prefix + mod.replace("/", ".")
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf not in ("scale", "bias"):
            raise ValueError(f"unknown entry in the param tree: {path}")
        out[f"{name}.{'bias' if leaf == 'bias' else 'weight'}"] = arr
    for path, arr in _flatten(batch_stats or {}).items():
        mod, leaf = path.rsplit("/", 1)
        if leaf not in _STATS:
            raise ValueError(f"unknown entry in batch_stats: {path}")
        out[f"{prefix}{mod.replace('/', '.')}.{_STATS[leaf]}"] = arr
    return _tensors(out)


def image_to_flax(state_dict: Mapping, prefix: str = ""):
    """(params, batch_stats) in the flax layout of a port image model's
    state_dict: the inverse of `image_from_flax`.  A 4-D weight is a
    Conv kernel, a 2-D one a Dense kernel, a 1-D one a BatchNorm
    scale."""
    params, stats = {}, {}
    inverse = {v: k for k, v in _STATS.items()}
    for name, t in state_dict.items():
        if not name.startswith(prefix):
            raise ValueError(f"{name} is not under {prefix!r}")
        mod, leaf = name[len(prefix):].rsplit(".", 1)
        path = mod.replace(".", "/")
        arr = np.array(t.detach().cpu().float())
        if leaf in inverse:
            stats[f"{path}/{inverse[leaf]}"] = arr
        elif leaf == "bias":
            params[f"{path}/bias"] = arr
        elif leaf == "weight" and arr.ndim in (2, 4):
            params[f"{path}/kernel"] = np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T)
        elif leaf == "weight" and arr.ndim == 1:
            params[f"{path}/scale"] = arr
        else:
            raise ValueError(f"unknown entry in the state_dict: {name}")
    return _unflatten(params), _unflatten(stats)


def text_classifier_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `TextClassifier` state_dict from the JAX module's param
    tree (`embed`, `conv` or the recurrent `cell`, `fc`, `head`)."""
    return _renamed_from_flax(params, [(r"embed|conv|cell|fc|head", r"\g<0>")])


def text_classifier_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `TextClassifier` param tree of the port's weights."""
    return _renamed_to_flax(state_dict, [(r"embed", "embed", True),
                                         (r"conv|cell|fc|head", r"\g<0>",
                                          False)])


def anomaly_detector_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `AnomalyDetector` state_dict from the JAX module's
    param tree: LSTM cell i (`lstm_cell_i`) as `lstm.i`, `head`."""
    return _renamed_from_flax(params, [(r"lstm_cell_(\d+)", r"lstm.\1"),
                                       (r"head", "head")])


def anomaly_detector_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `AnomalyDetector` param tree of the port's weights."""
    return _renamed_to_flax(state_dict, [
        (r"lstm\.(\d+)", r"lstm_cell_\1", False), (r"head", "head", False)])


def seq2seq_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `Seq2Seq` state_dict from the JAX module's param tree:
    `enc_cells_i` / `dec_cells_i` as `enc_cells.i` / `dec_cells.i`,
    `bridge_dense_i_j` as `bridge_dense.i.j`, `generator`."""
    return _renamed_from_flax(params, [
        (r"(enc|dec)_cells_(\d+)", r"\1_cells.\2"),
        (r"bridge_dense_(\d+)_(\d+)", r"bridge_dense.\1.\2"),
        (r"generator", "generator")])


def seq2seq_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `Seq2Seq` param tree of the port's weights."""
    return _renamed_to_flax(state_dict, [
        (r"(enc|dec)_cells\.(\d+)", r"\1_cells_\2", False),
        (r"bridge_dense\.(\d+)\.(\d+)", r"bridge_dense_\1_\2", False),
        (r"generator", "generator", False)])


def knrm_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `KNRM` state_dict from the JAX module's param tree
    (`embed`, `head`)."""
    return _renamed_from_flax(params, [(r"embed|head", r"\g<0>")])


def knrm_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `KNRM` param tree of the port's weights."""
    return _renamed_to_flax(state_dict, [(r"embed", "embed", True),
                                         (r"head", "head", False)])


def vae_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `VAE` state_dict from the JAX module's param tree: its
    modules are named as the flax ones (`image_from_flax`; a
    ConvTranspose kernel is laid out as a Conv's, unflipped)."""
    return image_from_flax(params)


def vae_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `VAE` param tree of the port's weights."""
    return image_to_flax(state_dict)[0]


def _keras_roots(gm) -> Dict[str, tuple]:
    """{flax top-level key: (state_dict prefix, module)} of a built Keras
    graph module: a layer's module under its name, save the recurrent
    layers, whose flax cells sit beside it (`lstm_1_cell`, and a
    Bidirectional's `_fwd_cell` / `_bwd_cell`; ConvLSTM's `_cell`)."""
    from analytics_zoo_tpu_torch.keras.layers.convolutional_recurrent import (
        _ConvLSTMCell)
    from analytics_zoo_tpu_torch.keras.layers.recurrent import (
        Recurrent, _Bidirectional)
    roots = {}
    for name, mod in gm.named_children():
        if isinstance(mod, (Recurrent, _ConvLSTMCell)):
            roots[f"{name}_cell"] = (name + ".", mod)
        elif isinstance(mod, _Bidirectional):
            roots[f"{name}_fwd_cell"] = (f"{name}.fwd.", mod.fwd)
            roots[f"{name}_bwd_cell"] = (f"{name}.bwd.", mod.bwd)
        else:
            roots[name] = (name + ".", mod)
    return roots


def _keras_leaf_rules(mod):
    """[(flax leaf, torch entry, to_torch(arr), to_flax(arr))] of a
    module whose own entries flax names otherwise or lays out otherwise;
    None for a module whose entries carry flax's names and layouts."""
    from torch import nn as tnn

    from analytics_zoo_tpu_torch.keras.layers.conv import ConvND
    from analytics_zoo_tpu_torch.models.image.imageclassification.layers \
        import BatchNorm
    from analytics_zoo_tpu_torch.ops.dense import DenseGelu
    from analytics_zoo_tpu_torch.ops.normalization import LayerNorm

    def same(a):
        return a

    def transpose(a):
        return np.ascontiguousarray(a.T)

    if isinstance(mod, (tnn.Linear, DenseGelu)):
        return [("kernel", "weight", transpose, transpose),
                ("bias", "bias", same, same)]
    if isinstance(mod, ConvND):
        n = mod.weight.dim()
        return [("kernel", "weight",
                 lambda a: np.ascontiguousarray(
                     np.moveaxis(a, (n - 1, n - 2), (0, 1))),
                 lambda a: np.ascontiguousarray(
                     np.moveaxis(a, (0, 1), (n - 1, n - 2)))),
                ("bias", "bias", same, same)]
    if isinstance(mod, tnn.Embedding):
        return [("embedding", "weight", same, same)]
    if isinstance(mod, (LayerNorm, BatchNorm)):
        return [("scale", "weight", same, same), ("bias", "bias", same, same)]
    return None


def _keras_module_from_flax(mod, tree: Mapping, stats: Mapping, prefix: str,
                            out: Dict[str, np.ndarray], where: str) -> None:
    from analytics_zoo_tpu_torch.keras.layers.recurrent import Recurrent
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        TransformerEncoder)
    tree, stats = dict(tree), dict(stats or {})

    def pop(key):
        if key not in tree:
            raise ValueError(f"missing {where}/{key} in the param tree")
        return tree.pop(key)

    if isinstance(mod, Recurrent):
        for k, v in recurrent.cell_from_flax(tree, where).items():
            out[f"{prefix}cell.{k}"] = v
        return
    if isinstance(mod, TransformerEncoder) and "blocks" in tree:
        # the scan-stacked layout: each leaf's leading axis is the block
        stacked = tree.pop("blocks")
        for i in range(len(mod.blocks)):
            tree[f"block_{i}"] = _map_tree(stacked, lambda a, i=i: a[i])
    rules = _keras_leaf_rules(mod)
    if rules is not None:
        for leaf, entry, to_torch, _ in rules:
            if getattr(mod, entry, None) is not None:
                out[prefix + entry] = to_torch(np.asarray(pop(leaf)))
        for leaf, buf in _STATS.items():
            if hasattr(mod, buf):
                if leaf not in stats:
                    raise ValueError(f"missing {where}/{leaf} in batch_stats")
                out[prefix + buf] = np.asarray(stats.pop(leaf))
    else:
        for name, _ in mod.named_parameters(recurse=False):
            out[prefix + name] = np.asarray(pop(name))
    for name, child in mod.named_children():
        if isinstance(mod, TransformerEncoder) and name == "blocks":
            for i, blk in enumerate(child):
                _keras_module_from_flax(blk, pop(f"block_{i}"),
                                        stats.pop(f"block_{i}", None),
                                        f"{prefix}blocks.{i}.", out,
                                        f"{where}/block_{i}")
            continue
        if not any(True for _ in child.parameters()) and not any(
                True for _ in child.buffers()):
            continue
        _keras_module_from_flax(child, pop(name), stats.pop(name, None),
                                f"{prefix}{name}.", out, f"{where}/{name}")
    if tree or stats:
        raise ValueError(f"unknown entries under {where}: "
                         f"{sorted(tree) + sorted(stats)}")


def _map_tree(tree: Mapping, fn) -> Dict:
    return {k: _map_tree(v, fn) if isinstance(v, Mapping) else fn(np.asarray(v))
            for k, v in tree.items()}


def keras_from_flax(model, params: Mapping,
                    batch_stats: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """The state_dict of a built Keras graph module (`model`: the module
    `Estimator.from_keras(...).get_model()` trains, or `keras_model.
    to_torch().build(*sample)`) from the flax `params` (and
    `batch_stats`) of the JAX package's same graph, matched by layer
    name.  Each module takes its layer's flax subtree: Dense kernels
    transposed, Conv kernels (*k, in, out) as weights (out, in, *k),
    Embed tables, LayerNorm / BatchNorm scales (and batch_stats mean /
    var as running_mean / running_var), a recurrent cell through
    `models/common/recurrent.cell_from_flax`, a transformer encoder's
    blocks in either of flax's layouts (scan-stacked `blocks/...` or
    `block_{i}`, as `bert_from_flax` takes them), and every other
    parameter under its flax name and layout.  Raises on a missing or
    unknown entry."""
    params, stats = dict(params), dict(batch_stats or {})
    out: Dict[str, np.ndarray] = {}
    for key, (prefix, mod) in _keras_roots(model).items():
        if not any(True for _ in mod.parameters()):
            continue
        if key not in params:
            raise ValueError(f"missing {key} in the param tree")
        _keras_module_from_flax(mod, params.pop(key), stats.pop(key, None),
                                prefix, out, key)
    if params or stats:
        raise ValueError(f"unknown entries in the param tree: "
                         f"{sorted(params) + sorted(stats)}")
    return _tensors(out)


def _keras_module_to_flax(mod, sd: Dict[str, np.ndarray], prefix: str,
                          stacked: bool):
    """(params, batch_stats) subtrees of one module (the inverse of
    `_keras_module_from_flax`)."""
    from analytics_zoo_tpu_torch.keras.layers.recurrent import Recurrent
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        TransformerEncoder)
    tree: Dict = {}
    stats: Dict = {}
    if isinstance(mod, Recurrent):
        cell = {k: sd.pop(f"{prefix}cell.{k}") for k in
                ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")}
        return recurrent.cell_to_flax(cell), {}
    rules = _keras_leaf_rules(mod)
    if rules is not None:
        for leaf, entry, _, to_flax in rules:
            if getattr(mod, entry, None) is not None:
                tree[leaf] = to_flax(sd.pop(prefix + entry))
        for leaf, buf in _STATS.items():
            if hasattr(mod, buf):
                stats[leaf] = sd.pop(prefix + buf)
    else:
        for name, _ in mod.named_parameters(recurse=False):
            tree[name] = sd.pop(prefix + name)
    for name, child in mod.named_children():
        if isinstance(mod, TransformerEncoder) and name == "blocks":
            blocks = [_keras_module_to_flax(b, sd, f"{prefix}blocks.{i}.",
                                            stacked)[0]
                      for i, b in enumerate(child)]
            if stacked and blocks:
                tree["blocks"] = _stack_trees(blocks)
            else:
                tree.update({f"block_{i}": b for i, b in enumerate(blocks)})
            continue
        if not any(True for _ in child.parameters()) and not any(
                True for _ in child.buffers()):
            continue
        sub, sub_stats = _keras_module_to_flax(child, sd, f"{prefix}{name}.",
                                               stacked)
        tree[name] = sub
        if sub_stats:
            stats[name] = sub_stats
    return tree, stats


def _stack_trees(trees):
    first = trees[0]
    return {k: _stack_trees([t[k] for t in trees]) if isinstance(v, Mapping)
            else np.stack([t[k] for t in trees]) for k, v in first.items()}


def keras_to_flax(model, state_dict: Optional[Mapping] = None,
                  stacked: bool = True):
    """(params, batch_stats) in the flax layout of the JAX package's same
    Keras graph: the inverse of `keras_from_flax`.  `state_dict`
    defaults to the module's own; `stacked` gives a transformer
    encoder's blocks scan-stacked (JAX's default), else unrolled."""
    if state_dict is None:
        state_dict = model.state_dict()
    sd = {k: np.array(v.detach().cpu().float() if torch.is_tensor(v) else v)
          for k, v in state_dict.items()}
    params, stats = {}, {}
    for key, (prefix, mod) in _keras_roots(model).items():
        if not any(True for _ in mod.parameters()):
            continue
        tree, st = _keras_module_to_flax(mod, sd, prefix, stacked)
        params[key] = tree
        if st:
            stats[key] = st
    if sd:
        raise ValueError(f"unknown entries in the state_dict: {sorted(sd)}")
    return params, stats


def onnx_from_flax(module, variables: Mapping) -> Dict[str, torch.Tensor]:
    """The state_dict of an `OnnxModule` from the JAX `OnnxModule`'s
    variables: `params` are its parameters, `batch_stats` its BatchNorm
    buffers, both under the initializers' safe names.  Copies (the
    arrays are never viewed).  Raises on a missing or unknown entry."""
    want = {safe for safe in module.bound.values()}
    out = {}
    for coll in ("params", "batch_stats"):
        for name, arr in dict(variables.get(coll, {})).items():
            if name not in want:
                raise ValueError(f"unknown entry {coll}/{name}")
            out[name] = torch.tensor(np.array(arr))
    missing = want - set(out)
    if missing:
        raise ValueError(f"missing entries {sorted(missing)}")
    return out


def onnx_to_flax(module) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX `OnnxModule`'s variables of an `OnnxModule`'s weights:
    {"params": parameters, "batch_stats": BatchNorm buffers}, as numpy
    copies (the inverse of `onnx_from_flax`)."""
    params = dict(module.named_parameters())
    out: Dict[str, Dict[str, np.ndarray]] = {"params": {}}
    for safe in module.bound.values():
        t = params.get(safe)
        coll = "params"
        if t is None:
            t, coll = getattr(module, safe), "batch_stats"
        out.setdefault(coll, {})[safe] = np.array(t.detach().cpu())
    return out


def _modules(params: Mapping) -> Dict[str, Dict]:
    """A nested flax tree as {module path "a/b": {leaf: array}}."""
    mods: Dict[str, Dict] = {}
    for path, arr in _flatten(params).items():
        mod, leaf = path.rsplit("/", 1)
        mods.setdefault(mod, {})[leaf] = arr
    return mods


def _nested(tree: Mapping) -> Dict:
    """The inverse of `_modules` on a tree whose keys are module paths."""
    return _unflatten({f"{mod}/{leaf}": arr for mod, leaves in tree.items()
                       for leaf, arr in _flatten(leaves).items()})


def tcn_forecaster_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's TCN (`chronos/forecaster/tcn_forecaster.py`) state_dict
    from the JAX `_TCN`'s param tree: `block_i/conv1|conv2|downsample`
    as `blocks.i.*`, a conv kernel (k, in, out) as the weight (out, in,
    k), `head`."""
    return _renamed_from_flax(_modules(params), [
        (r"block_(\d+)/(conv1|conv2|downsample)", r"blocks.\1.\2"),
        (r"head", "head")])


def tcn_forecaster_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `_TCN` param tree of the port's weights."""
    return _nested(_renamed_to_flax(state_dict, [
        (r"blocks\.(\d+)\.(conv1|conv2|downsample)", r"block_\1/\2", False),
        (r"head", "head", False)]))


def lstm_forecaster_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `VanillaLSTM` state_dict from the JAX module's param
    tree: LSTM cell i (`lstm_cell_i`) as `lstm.i`, `head`."""
    return _renamed_from_flax(params, [(r"lstm_cell_(\d+)", r"lstm.\1"),
                                       (r"head", "head")])


def lstm_forecaster_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `_VanillaLSTM` param tree of the port's weights."""
    return _renamed_to_flax(state_dict, [
        (r"lstm\.(\d+)", r"lstm_cell_\1", False), (r"head", "head", False)])


#: a decoder cell's weights are an `nn.LSTMCell`'s: the RNN's without "_l0"
_DEC_CELL = re.compile(r"(dec_cells\.\d+\.\w+)_l0")


def seq2seq_forecaster_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `Seq2SeqForecastNet` state_dict from the JAX module's
    param tree: `enc_cells_i` as the one-layer LSTM `enc_cells.i`,
    `dec_cells_i` as the `nn.LSTMCell` `dec_cells.i`, `head`."""
    sd = _renamed_from_flax(params, [
        (r"(enc|dec)_cells_(\d+)", r"\1_cells.\2"), (r"head", "head")])
    return {_DEC_CELL.sub(r"\1", k): v for k, v in sd.items()}


def seq2seq_forecaster_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `_Seq2SeqForecastNet` param tree of the port's weights."""
    sd = {re.sub(r"^(dec_cells\.\d+\.(?:weight|bias)_(?:ih|hh))$", r"\1_l0",
                 k): v for k, v in state_dict.items()}
    return _renamed_to_flax(sd, [
        (r"(enc|dec)_cells\.(\d+)", r"\1_cells_\2", False),
        (r"head", "head", False)])


def _module_tree(params: Mapping, prefix: str = "") -> Dict[str, Mapping]:
    """A nested flax tree as {module path "a/b": its subtree}, down to
    the modules that hold leaves or are recurrent cells (which
    `_renamed_from_flax` converts whole)."""
    out: Dict[str, Mapping] = {}
    for k, v in params.items():
        path = f"{prefix}{k}"
        if recurrent.is_cell(v) or not any(isinstance(c, Mapping)
                                           for c in v.values()):
            out[path] = v
        else:
            out.update(_module_tree(v, path + "/"))
    return out


_MTNET_FROM = [(r"(mem|short)_encoder/GRUCell_0", r"\1_encoder.gru"),
               (r"(mem|short)_encoder/(conv|attn_proj|attn)",
                r"\1_encoder.\2"),
               (r"head", "head"), (r"ar", "ar")]
_MTNET_TO = [(r"(mem|short)_encoder\.gru", r"\1_encoder/GRUCell_0", False),
             (r"(mem|short)_encoder\.(conv|attn_proj|attn)",
              r"\1_encoder/\2", False),
             (r"head", "head", False), (r"ar", "ar", False)]


def mtnet_forecaster_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's `MTNet` state_dict from the JAX `_MTNet`'s param tree:
    each encoder's `conv` (kernel (3, in, out) as (out, in, 3)),
    `attn_proj`, `attn` and `GRUCell_0` (as `gru`), `head`, and `ar`
    (DenseGeneral's kernel (ar, horizon), transposed as a Linear's)."""
    return _renamed_from_flax(_module_tree(params), _MTNET_FROM)


def mtnet_forecaster_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `_MTNet` param tree of the port's weights."""
    return _nested(_renamed_to_flax(state_dict, _MTNET_TO))


def tcmf_factorization_from_flax(params: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """TCMF's factorization (`tcmf_forecaster._Factorization`): flax's
    `embed_f` table as `embed_f.weight`, `x_basis` as it is."""
    return _tensors({"embed_f.weight": params["embed_f"]["embedding"],
                     "x_basis": params["x_basis"]})


def tcmf_factorization_to_flax(state_dict: Mapping) -> Dict:
    """The JAX `_Factorization` param tree of the port's weights."""
    def arr(k):
        return np.array(state_dict[k].detach().cpu().float())
    return {"embed_f": {"embedding": arr("embed_f.weight")},
            "x_basis": arr("x_basis")}


def ae_detector_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The AE detector's autoencoder (`detectors._AE`): `enc`, `dec`."""
    return _renamed_from_flax(params, [(r"(enc|dec)", r"\1")])


def ae_detector_to_flax(state_dict: Mapping) -> Dict:
    """The JAX AE detector's param tree of the port's weights."""
    return _renamed_to_flax(state_dict, [(r"(enc|dec)", r"\1", False)])


def dpgan_generator_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The DoppelGANger simulator's generator
    (`doppelganger_simulator._Generator`) from JAX's `{"attr", "seq"}`
    tree: the attribute MLP's `Dense_i` as `attr.layers.i`, the sequence
    generator's `GRUCell_0` as `seq.gru` and `out`."""
    return _renamed_from_flax(_module_tree(params), [
        (r"attr/Dense_(\d+)", r"attr.layers.\1"),
        (r"seq/GRUCell_0", "seq.gru"), (r"seq/out", "seq.out")])


def dpgan_generator_to_flax(state_dict: Mapping) -> Dict:
    """JAX's generator tree `{"attr", "seq"}` of the port's weights."""
    return _nested(_renamed_to_flax(state_dict, [
        (r"attr\.layers\.(\d+)", r"attr/Dense_\1", False),
        (r"seq\.gru", "seq/GRUCell_0", False),
        (r"seq\.out", "seq/out", False)]))


def dpgan_discriminator_from_flax(params: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """The simulator's discriminator: `Dense_i` as `layers.i`."""
    return _renamed_from_flax(params, [(r"Dense_(\d+)", r"layers.\1")])


def dpgan_discriminator_to_flax(state_dict: Mapping) -> Dict:
    """JAX's discriminator tree of the port's weights."""
    return _renamed_to_flax(state_dict,
                            [(r"layers\.(\d+)", r"Dense_\1", False)])
