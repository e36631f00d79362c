"""Embedding layers (counterpart of
analytics_zoo_tpu/keras/layers/embeddings.py): Embedding,
WordEmbedding with its GloVe / word2vec text reader, and
SparseEmbedding."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer


def flax_embedding(n: int, d: int, device=None) -> nn.Embedding:
    """flax `nn.Embed(n, d)`: the table drawn N(0, 1/d)."""
    emb = nn.Embedding(n, d, device=device)
    with torch.no_grad():
        emb.weight.normal_(0.0, d ** -0.5)
    return emb


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int,
                 name: Optional[str] = None, **_):
        super().__init__(name)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def build(self, x):
        return flax_embedding(self.input_dim, self.output_dim, x.device)

    def apply(self, m, x, training=False, generator=None, impl="auto"):
        return m(x.long())


class _WordEmbeddingModule(nn.Module):
    """The table as the parameter `embedding` when trainable, else a
    buffer outside the state_dict (JAX keeps a frozen table out of the
    params)."""

    def __init__(self, weights: np.ndarray, trainable: bool, device=None):
        super().__init__()
        table = torch.tensor(weights, device=device)
        if trainable:
            self.embedding = nn.Parameter(table)
        else:
            self.register_buffer("embedding", table, persistent=False)

    def forward(self, ids):
        return self.embedding[ids.long()]


class WordEmbedding(Layer):
    """Embedding initialized from pretrained vectors (frozen by
    default)."""

    def __init__(self, weights, trainable: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.weights = np.asarray(weights, np.float32)
        self.trainable = trainable

    @staticmethod
    def from_word_index(word_index: dict, vectors: dict, dim: int,
                        trainable: bool = False,
                        name: Optional[str] = None) -> "WordEmbedding":
        """Build the table from {word: idx} + {word: vector} (ids start
        at 1; row 0 is the pad vector)."""
        n = max(word_index.values()) + 1
        table = np.zeros((n, dim), np.float32)
        for w, i in word_index.items():
            v = vectors.get(w)
            if v is not None:
                table[i] = np.asarray(v, np.float32)
        return WordEmbedding(table, trainable, name)

    def build(self, x):
        return _WordEmbeddingModule(self.weights, self.trainable, x.device)


def read_glove_vectors(path: str):
    """Parse a GloVe/word2vec-style text file, one `word v1 ... vD` per
    line, into ({word: vector}, dim).  A leading word2vec header line
    ("<count> <dim>") is skipped; an all-digit first line of two tokens
    is taken for a header only when the rest of the file agrees with
    its dim."""
    vectors = {}
    dim = None
    header = None
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f):
            parts = line.split()
            if (lineno == 0 and len(parts) == 2
                    and all(p.isdigit() for p in parts)):
                header = parts
                continue
            if len(parts) < 2:
                continue
            word, vals = parts[0], parts[1:]
            vec = np.asarray([float(v) for v in vals], np.float32)
            if dim is None:
                dim = len(vec)
            elif len(vec) != dim:
                raise ValueError(
                    f"{path}:{lineno + 1}: vector for {word!r} has "
                    f"{len(vec)} dims, expected {dim}")
            vectors[word] = vec
    if header is not None:
        declared = int(header[1])
        if dim is None:
            # the candidate was the whole file: a 1-D vector, no header
            dim = 1
            vectors[header[0]] = np.asarray([float(header[1])], np.float32)
        elif declared == dim:
            pass  # a true header
        elif dim == 1:
            # the first line was a 1-D vector after all
            vectors[header[0]] = np.asarray([float(header[1])], np.float32)
        else:
            raise ValueError(
                f"{path}: first line {' '.join(header)!r} is neither a "
                f"word2vec header for dim {dim} nor a dim-{dim} vector")
    if dim is None:
        raise ValueError(f"{path}: no vectors found")
    return vectors, dim


def glove_word_embedding(path: str, word_index: dict,
                         trainable: bool = False,
                         name: Optional[str] = None) -> WordEmbedding:
    """WordEmbedding straight from a GloVe file and a {word: idx}
    vocabulary (ids start at 1; row 0 pads; words not in the file keep
    zero vectors)."""
    vectors, dim = read_glove_vectors(path)
    return WordEmbedding.from_word_index(word_index, vectors, dim,
                                         trainable=trainable, name=name)


class _SparseEmbeddingModule(nn.Module):
    """`embedding [input_dim, output_dim]` from U(-0.05, 0.05)."""

    def __init__(self, input_dim: int, output_dim: int, combiner: str,
                 max_norm: float, device=None):
        super().__init__()
        self.combiner, self.max_norm = combiner, max_norm
        self.embedding = nn.Parameter(torch.empty(input_dim, output_dim,
                                                  device=device))
        nn.init.uniform_(self.embedding, -0.05, 0.05)

    def forward(self, ids, weights=None):
        mask = ids >= 0
        rows = self.embedding[ids.long().clamp_min(0)]          # [b,k,out]
        if self.max_norm > 0:
            norm = torch.linalg.norm(rows, dim=-1, keepdim=True)
            rows = rows * torch.clamp_max(
                self.max_norm / norm.clamp_min(1e-12), 1.0)
        w = (torch.where(mask, weights, 0.0) if weights is not None
             else mask.to(rows.dtype))
        s = (rows * w[..., None]).sum(dim=-2)
        if self.combiner == "sum":
            return s
        if self.combiner == "mean":
            return s / w.sum(dim=-1, keepdim=True).clamp_min(1e-12)
        sq = torch.sqrt(w.square().sum(dim=-1, keepdim=True))
        return s / sq.clamp_min(1e-12)


class SparseEmbedding(Layer):
    """Embedding-bag over id rows: `ids` [b, k] with -1 padding (and
    optional per-id `weights` [b, k] as a second input), reduced per row
    by `combiner` ("sum", "mean" or "sqrtn"); `max_norm` > 0 l2-clips
    each embedding before the reduction."""

    def __init__(self, input_dim: int, output_dim: int,
                 combiner: str = "sum", max_norm: float = -1.0,
                 name: Optional[str] = None, **_):
        super().__init__(name)
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError("combiner must be sum|mean|sqrtn")
        self.input_dim, self.output_dim = input_dim, output_dim
        self.combiner, self.max_norm = combiner, max_norm

    def build(self, ids, weights=None):
        return _SparseEmbeddingModule(self.input_dim, self.output_dim,
                                      self.combiner, self.max_norm,
                                      ids.device)
