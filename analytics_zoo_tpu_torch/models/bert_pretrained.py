"""Pretrained BERT weight import and export (counterpart of
analytics_zoo_tpu/models/bert_pretrained.py; reference:
`init_checkpoint` name mapping in pyzoo/zoo/tfpark/text/estimator/
bert_base.py:45-48, `get_assignment_map_from_checkpoint`).

Published BERT weights (HF-style state dicts, ``pytorch_model.bin`` or
``model.safetensors``, or TF1-style name -> array dicts and ``.npz``
exports) are mapped into the flax `TransformerEncoder` tree by the JAX
module's numpy code, carried over as it is (its `jax.tree_util` walks
are dict walks here):

* q/k/v kernels fuse into the single ``qkv`` kernel,
* per-layer weights stack along the leading ``[n_block, ...]`` axis of
  the scan layout (or fill ``block_i`` subtrees in the unrolled one),
* torch ``Linear.weight`` ([out, in]) transposes into flax ``kernel``
  ([in, out]); TF1 kernels load as-is,
* position embeddings longer than the model's ``max_position_len`` are
  sliced (the standard short-sequence fine-tune setup).

A port model reaches that tree through its `flax_layout()` pair
(`models/bert.py`): `load_bert_pretrained` and `export_bert_weights`
take a port BERT module (`Estimator.get_model()`), its state_dict (what
a callable given to `Estimator.set_params` receives), and return a
state_dict for either; given a flax param tree they return one, as in
JAX.  ``.safetensors`` files need the `safetensors` package, imported
only when one is read.

Typical flow::

    model = BERTClassifier(...)
    est = model.estimator(learning_rate=2e-5)
    est.set_params(lambda p: load_bert_pretrained(p, "pytorch_model.bin"))
    est.fit(train_data, epochs=3, batch_size=32)
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["read_pretrained", "load_bert_pretrained",
           "export_bert_weights"]


# ---------------------------------------------------------------------------
# reading checkpoint files
# ---------------------------------------------------------------------------

def read_pretrained(path: str) -> Dict[str, np.ndarray]:
    """Load a name→ndarray dict from a checkpoint file or directory.

    Supports ``.npz``, ``.safetensors``, and torch pickles
    (``.bin``/``.pt``); a directory is searched for the usual HF file
    names.  (TF1 ``.ckpt`` binaries need TF to parse; export them to
    ``.npz`` first — names are preserved, so the TF1 name scheme below
    still applies.)
    """
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin",
                     "bert.npz", "weights.npz"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no recognized checkpoint file in {path!r} (looked for "
                "model.safetensors / pytorch_model.bin / *.npz)")
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        return dict(load_file(path))
    if path.endswith((".bin", ".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        return {k: v.detach().cpu().numpy() for k, v in sd.items()
                if hasattr(v, "detach")}
    raise ValueError(f"unrecognized checkpoint format: {path!r}")


# ---------------------------------------------------------------------------
# name canonicalization
# ---------------------------------------------------------------------------

# canonical key -> (regex over normalized names, is_dense_kernel)
# normalized = separators to "/", optional leading "bert/" stripped;
# TF1 and HF spellings both covered.  is_dense_kernel marks arrays that
# need the torch [out, in] -> [in, out] transpose.
_EMBED_PATTERNS = {
    "word_embeddings": r"embeddings/word_embeddings(/weight)?$",
    "position_embeddings": r"embeddings/position_embeddings(/weight)?$",
    "token_type_embeddings": r"embeddings/token_type_embeddings(/weight)?$",
    "embed_ln_scale": r"embeddings/LayerNorm/(gamma|weight)$",
    "embed_ln_bias": r"embeddings/LayerNorm/(beta|bias)$",
    "pooler_kernel": r"pooler/dense/(kernel|weight)$",
    "pooler_bias": r"pooler/dense/bias$",
}
_LAYER_PATTERNS = {
    "q_kernel": r"attention/self/query/(kernel|weight)$",
    "q_bias": r"attention/self/query/bias$",
    "k_kernel": r"attention/self/key/(kernel|weight)$",
    "k_bias": r"attention/self/key/bias$",
    "v_kernel": r"attention/self/value/(kernel|weight)$",
    "v_bias": r"attention/self/value/bias$",
    "proj_kernel": r"attention/output/dense/(kernel|weight)$",
    "proj_bias": r"attention/output/dense/bias$",
    "ln1_scale": r"attention/output/LayerNorm/(gamma|weight)$",
    "ln1_bias": r"attention/output/LayerNorm/(beta|bias)$",
    "fc1_kernel": r"intermediate/dense/(kernel|weight)$",
    "fc1_bias": r"intermediate/dense/bias$",
    "fc2_kernel": r"(?<!attention/)output/dense/(kernel|weight)$",
    "fc2_bias": r"(?<!attention/)output/dense/bias$",
    "ln2_scale": r"(?<!attention/)output/LayerNorm/(gamma|weight)$",
    "ln2_bias": r"(?<!attention/)output/LayerNorm/(beta|bias)$",
}
_KERNEL_KEYS = frozenset(k for k in list(_EMBED_PATTERNS)
                         + list(_LAYER_PATTERNS) if k.endswith("_kernel"))
_LAYER_RE = re.compile(r"encoder/layer[_./]?(\d+)/")


def _canonicalize(named: Dict[str, np.ndarray]):
    """-> (embed_dict, {layer_i: layer_dict}).  Torch-layout 2-D dense
    weights (names ending ``.weight``) are transposed to [in, out]."""
    embeds: Dict[str, np.ndarray] = {}
    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for raw, arr in named.items():
        name = raw.replace(".", "/")
        if name.startswith("bert/"):
            name = name[len("bert/"):]
        torch_layout = raw.endswith(".weight") or raw.endswith(".bias")
        m = _LAYER_RE.search(name)
        if m:
            idx = int(m.group(1))
            rest = name[m.end():]
            for key, pat in _LAYER_PATTERNS.items():
                if re.search(pat, "/" + rest):
                    a = np.asarray(arr)
                    if (key in _KERNEL_KEYS and torch_layout
                            and a.ndim == 2):
                        a = a.T
                    layers.setdefault(idx, {})[key] = a
                    break
            continue
        for key, pat in _EMBED_PATTERNS.items():
            if re.search(pat, "/" + name):
                a = np.asarray(arr)
                if key == "pooler_kernel" and torch_layout and a.ndim == 2:
                    a = a.T
                embeds[key] = a
                break
    return embeds, layers


# ---------------------------------------------------------------------------
# the flax tree of what the caller holds
# ---------------------------------------------------------------------------

def _map(fn, *trees):
    """`fn` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], Mapping):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def _as_tree(params) -> Tuple[Dict[str, Any], Callable]:
    """(the flax param tree of `params` as numpy, a function taking a
    filled tree back to what `params` is): a port BERT module or its
    state_dict go through the model's `flax_layout()` pair (back to a
    state_dict), a flax tree stays one."""
    from analytics_zoo_tpu_torch.models.bert import bert_layout
    if isinstance(params, torch.nn.Module):
        to_flax, from_flax = params.flax_layout()
        return to_flax(params.state_dict()), from_flax
    if any(torch.is_tensor(v) for v in params.values()):
        to_flax, from_flax = bert_layout(params)
        return to_flax(params), from_flax
    return _map(np.asarray, params), lambda tree: tree


# ---------------------------------------------------------------------------
# filling the flax tree
# ---------------------------------------------------------------------------

def _check(name: str, got: np.ndarray, want_shape) -> np.ndarray:
    if tuple(got.shape) != tuple(want_shape):
        raise ValueError(
            f"pretrained {name}: shape {tuple(got.shape)} does not match "
            f"model shape {tuple(want_shape)}; configure the model to the "
            "checkpoint's architecture (hidden/heads/blocks/vocab)")
    return got.astype(np.float32)


def load_bert_pretrained(params: Any, source,
                         encoder: str = "bert",
                         strict: bool = True) -> Any:
    """Return a copy of `params` (a port BERT module or its state_dict:
    a state_dict; a flax tree: a flax tree) with the `encoder` weights
    filled from a pretrained checkpoint (path or name->array dict).
    Head parameters (classifier/ner_head/span_head) keep their fresh
    initialization, exactly the reference's fine-tune setup
    (bert_base.py:45-48 restores only ``bert/*`` variables).

    `strict`: raise if the checkpoint is missing any encoder weight the
    model has (position slicing excepted); False fills what it can.
    """
    if isinstance(source, str):
        source = read_pretrained(source)
    embeds, layers = _canonicalize(source)
    params, back = _as_tree(params)
    if encoder not in params:
        raise ValueError(f"params has no {encoder!r} subtree; keys: "
                         f"{list(params)}")
    bert = dict(params[encoder])

    def fill(sub: str, leaf: str, key: str, slice_rows: bool = False):
        if key not in embeds:
            if strict:
                raise ValueError(f"checkpoint missing {key} "
                                 f"(for {encoder}/{sub}/{leaf})")
            return
        tgt = dict(bert[sub])
        want = np.asarray(tgt[leaf]).shape
        arr = embeds[key]
        if slice_rows and arr.shape[0] > want[0]:
            # fine-tuning at shorter max_position_len than the published
            # 512 is the normal setup; keep the first rows
            arr = arr[:want[0]]
        tgt[leaf] = _check(key, arr, want)
        bert[sub] = tgt

    fill("token_embed", "embedding", "word_embeddings")
    fill("position_embed", "embedding", "position_embeddings",
         slice_rows=True)
    if "segment_embed" in bert:
        fill("segment_embed", "embedding", "token_type_embeddings")
    fill("embed_ln", "scale", "embed_ln_scale")
    fill("embed_ln", "bias", "embed_ln_bias")
    if "pooler" in bert:
        fill("pooler", "kernel", "pooler_kernel")
        fill("pooler", "bias", "pooler_bias")

    def layer_tree(i: int) -> Optional[Dict[str, Any]]:
        """None (keep the fresh init for layer i) when non-strict and
        the checkpoint lacks the layer or any of its weights."""
        lw = layers.get(i)
        missing = (set(_LAYER_PATTERNS) - set(lw)) if lw else None
        if lw is None or missing:
            if strict:
                raise ValueError(
                    f"checkpoint has no encoder layer {i}" if lw is None
                    else f"checkpoint layer {i} missing {sorted(missing)}")
            return None
        qkv_k = np.concatenate([lw["q_kernel"], lw["k_kernel"],
                                lw["v_kernel"]], axis=-1)
        qkv_b = np.concatenate([lw["q_bias"], lw["k_bias"],
                                lw["v_bias"]], axis=-1)
        return {
            "attn": {"qkv": {"kernel": qkv_k, "bias": qkv_b},
                     "proj": {"kernel": lw["proj_kernel"],
                              "bias": lw["proj_bias"]}},
            "ln1": {"scale": lw["ln1_scale"], "bias": lw["ln1_bias"]},
            "fc1": {"kernel": lw["fc1_kernel"], "bias": lw["fc1_bias"]},
            "fc2": {"kernel": lw["fc2_kernel"], "bias": lw["fc2_bias"]},
            "ln2": {"scale": lw["ln2_scale"], "bias": lw["ln2_bias"]},
        }

    if "blocks" in bert:           # scan layout: [n_block, ...] stacks
        stacked = bert["blocks"]
        n_block = np.asarray(_first_leaf(stacked)).shape[0]
        # a None entry (non-strict, layer absent) keeps the fresh slice
        per_layer = [layer_tree(i) for i in range(n_block)]
        per_layer = [
            new if new is not None
            else _map(lambda a, i=i: np.asarray(a)[i], stacked)
            for i, new in enumerate(per_layer)]
        bert["blocks"] = _map(
            lambda old, *new: _check("blocks", np.stack(new),
                                     np.asarray(old).shape),
            stacked, *per_layer)
    else:                          # unrolled layout: block_i subtrees
        i = 0
        while f"block_{i}" in bert:
            new = layer_tree(i)
            old = bert[f"block_{i}"]
            if new is not None:
                bert[f"block_{i}"] = _map(
                    lambda o, n, i=i: _check(f"block_{i}", np.asarray(n),
                                             np.asarray(o).shape), old, new)
            i += 1
        if i == 0:
            raise ValueError("params has neither 'blocks' (scan layout) "
                             "nor 'block_0' subtrees")

    out = dict(params)
    out[encoder] = bert
    return back(out)


# ---------------------------------------------------------------------------
# export (inverse mapping): migration tool and synthetic checkpoints
# ---------------------------------------------------------------------------

def export_bert_weights(params: Any, encoder: str = "bert",
                        fmt: str = "hf") -> Dict[str, np.ndarray]:
    """Inverse of `load_bert_pretrained`: flatten the encoder weights of
    `params` (a port BERT module, its state_dict or a flax tree) to
    published checkpoint names.  ``fmt="hf"`` emits HF-torch names and
    layout ([out, in] dense weights); ``fmt="tf1"`` emits TF1 names with
    flax-layout kernels."""
    if fmt not in ("hf", "tf1"):
        raise ValueError("fmt must be 'hf' or 'tf1'")
    params, _ = _as_tree(params)
    bert = params[encoder]
    hf = fmt == "hf"
    out: Dict[str, np.ndarray] = {}

    def put(hf_name: str, tf_name: str, arr: np.ndarray,
            dense_kernel: bool = False):
        a = np.asarray(arr)
        if hf and dense_kernel and a.ndim == 2:
            a = a.T
        # contiguous copy: safetensors serializes the raw buffer, and a
        # transposed view would silently write pre-transpose data
        out[("bert." + hf_name) if hf else
            ("bert/" + tf_name)] = np.ascontiguousarray(a)

    put("embeddings.word_embeddings.weight",
        "embeddings/word_embeddings", bert["token_embed"]["embedding"])
    put("embeddings.position_embeddings.weight",
        "embeddings/position_embeddings",
        bert["position_embed"]["embedding"])
    if "segment_embed" in bert:
        put("embeddings.token_type_embeddings.weight",
            "embeddings/token_type_embeddings",
            bert["segment_embed"]["embedding"])
    put("embeddings.LayerNorm.weight", "embeddings/LayerNorm/gamma",
        bert["embed_ln"]["scale"])
    put("embeddings.LayerNorm.bias", "embeddings/LayerNorm/beta",
        bert["embed_ln"]["bias"])
    if "pooler" in bert:
        put("pooler.dense.weight", "pooler/dense/kernel",
            bert["pooler"]["kernel"], dense_kernel=True)
        put("pooler.dense.bias", "pooler/dense/bias",
            bert["pooler"]["bias"])

    def layers():
        if "blocks" in bert:
            n = np.asarray(_first_leaf(bert["blocks"])).shape[0]
            for i in range(n):
                yield i, _map(lambda a, i=i: np.asarray(a)[i],
                              bert["blocks"])
        else:
            i = 0
            while f"block_{i}" in bert:
                yield i, bert[f"block_{i}"]
                i += 1

    for i, blk in layers():
        pre_hf = f"encoder.layer.{i}."
        pre_tf = f"encoder/layer_{i}/"
        qkv_k = np.asarray(blk["attn"]["qkv"]["kernel"])
        qkv_b = np.asarray(blk["attn"]["qkv"]["bias"])
        h = qkv_k.shape[-1] // 3
        for j, part in enumerate(("query", "key", "value")):
            put(pre_hf + f"attention.self.{part}.weight",
                pre_tf + f"attention/self/{part}/kernel",
                qkv_k[:, j * h:(j + 1) * h], dense_kernel=True)
            put(pre_hf + f"attention.self.{part}.bias",
                pre_tf + f"attention/self/{part}/bias",
                qkv_b[j * h:(j + 1) * h])
        put(pre_hf + "attention.output.dense.weight",
            pre_tf + "attention/output/dense/kernel",
            blk["attn"]["proj"]["kernel"], dense_kernel=True)
        put(pre_hf + "attention.output.dense.bias",
            pre_tf + "attention/output/dense/bias",
            blk["attn"]["proj"]["bias"])
        put(pre_hf + "attention.output.LayerNorm.weight",
            pre_tf + "attention/output/LayerNorm/gamma",
            blk["ln1"]["scale"])
        put(pre_hf + "attention.output.LayerNorm.bias",
            pre_tf + "attention/output/LayerNorm/beta",
            blk["ln1"]["bias"])
        put(pre_hf + "intermediate.dense.weight",
            pre_tf + "intermediate/dense/kernel",
            blk["fc1"]["kernel"], dense_kernel=True)
        put(pre_hf + "intermediate.dense.bias",
            pre_tf + "intermediate/dense/bias", blk["fc1"]["bias"])
        put(pre_hf + "output.dense.weight",
            pre_tf + "output/dense/kernel",
            blk["fc2"]["kernel"], dense_kernel=True)
        put(pre_hf + "output.dense.bias",
            pre_tf + "output/dense/bias", blk["fc2"]["bias"])
        put(pre_hf + "output.LayerNorm.weight",
            pre_tf + "output/LayerNorm/gamma", blk["ln2"]["scale"])
        put(pre_hf + "output.LayerNorm.bias",
            pre_tf + "output/LayerNorm/beta", blk["ln2"]["bias"])
    return out
