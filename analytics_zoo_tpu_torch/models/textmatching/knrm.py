"""KNRM, the kernel-pooling neural ranking model (counterpart of
analytics_zoo_tpu/models/textmatching/knrm.py:19-67; reference scala
`models/textmatching/KNRM.scala`): query and doc token embeddings, their
cosine translation matrix, RBF kernel pooling, a linear ranking score.
All f32.

Ids are clipped to [0, vocab_size - 1].  The kernel centers are
`kernel_num - 1` points evenly over [-1, 1] at width `sigma`, plus the
exact-match kernel at 1 with width `exact_sigma` (1e-3: its gradient is
up to ~1e6 times its value); soft-TF is `log1p` of the sum over the doc,
summed over the query.  In "classification" mode the output is a
sigmoid, and the default loss does not apply one again; in "ranking"
mode it is the raw score.  Weights come from a flax tree through
`convert.knrm_from_flax`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.common.ranker import Ranker
from analytics_zoo_tpu_torch.models.common.zoo_model import ZooModel
from analytics_zoo_tpu_torch.models.recommendation.ncf import embedding
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Dense,
)


class KNRM(ZooModel, Ranker, nn.Module):
    """(query_ids [b, text1_length], doc_ids [b, text2_length]) ->
    score [b, 1] f32."""

    def __init__(self, text1_length: int = 10, text2_length: int = 40,
                 vocab_size: int = 20000, embed_dim: int = 300,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001, target_mode: str = "ranking",
                 device=None):
        nn.Module.__init__(self)
        self._config = dict(text1_length=text1_length,
                            text2_length=text2_length, vocab_size=vocab_size,
                            embed_dim=embed_dim, kernel_num=kernel_num,
                            sigma=sigma, exact_sigma=exact_sigma,
                            target_mode=target_mode)
        self.device_ = dev = resolve_device(device)
        self.text1_length, self.text2_length = text1_length, text2_length
        self.vocab_size = vocab_size
        self.target_mode = target_mode
        self.embed = embedding(vocab_size, embed_dim, dev)
        self.head = Dense(kernel_num, 1, device=dev)
        mus = np.linspace(-1.0, 1.0, kernel_num - 1).tolist() + [1.0]
        sigmas = [sigma] * (kernel_num - 1) + [exact_sigma]
        self.register_buffer("mus", torch.tensor(mus, device=dev),
                             persistent=False)
        self.register_buffer("sigmas", torch.tensor(sigmas, device=dev),
                             persistent=False)

    @property
    def default_metrics(self):
        from analytics_zoo_tpu_torch.orca.learn.metrics import BinaryAccuracy
        return (BinaryAccuracy(
            from_logits=self.target_mode != "classification"),)

    @property
    def default_loss(self):
        # classification outputs sigmoid probabilities, so the loss must
        # not re-apply the sigmoid; ranking outputs raw scores (logits)
        if self.target_mode == "classification":
            from analytics_zoo_tpu_torch.orca.learn.losses import (
                binary_crossentropy,
            )
            return lambda p, l: binary_crossentropy(p, l, from_logits=False)
        return "binary_crossentropy"

    def flax_layout(self):
        """(to_flax(state_dict), from_flax(tree)): the JAX module's
        param tree (`convert.knrm_to_flax` and `knrm_from_flax`)."""
        from analytics_zoo_tpu_torch import convert
        return convert.knrm_to_flax, convert.knrm_from_flax

    def forward(self, query_ids, doc_ids):
        def unit(ids):
            e = self.embed(ids.long().clamp(0, self.vocab_size - 1)).float()
            return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True)
                        + 1e-8)
        # translation matrix [b, q_len, d_len]
        sim = torch.einsum("bqe,bde->bqd", unit(query_ids), unit(doc_ids))
        k = torch.exp(-((sim[..., None] - self.mus) ** 2)
                      / (2 * self.sigmas ** 2))
        # soft-TF: sum over doc, log, sum over query  [b, kernel_num]
        phi = torch.log1p(k.sum(dim=2)).sum(dim=1)
        score = self.head(phi)
        if self.target_mode == "classification":
            return torch.sigmoid(score)
        return score
