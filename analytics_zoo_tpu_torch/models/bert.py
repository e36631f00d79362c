"""The BERT family (counterpart of analytics_zoo_tpu/models/bert.py): a
`TransformerEncoder` with two segments and a head.

The constructor fields are the JAX modules' (defaults: BERT-base's
published widths, dropout 0.1; `remat` and `remat_policy` as
`TransformerEncoder` takes them), plus `compute_dtype` (bf16, the JAX default) and `device` (None = the CUDA
card, raising without one).  In training mode (`.train()`, the torch
default) dropout needs the `generator` argument of `forward`;
`InferenceModel` and `.eval()` switch it off.  Weights come from a flax
param tree through `convert.bert_from_flax` and go back through
`convert.bert_to_flax`.
"""

from __future__ import annotations

import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    TransformerEncoder,
    dropout,
)

#: BERT-base's published widths (12 blocks, 768 hidden, 12 heads of 64,
#: intermediate 3072, 512 positions, WordPiece vocab 30522)
BERT_BASE = dict(vocab=30522, hidden_size=768, n_head=12, n_block=12,
                 intermediate_size=3072, max_position_len=512)


class _BERT(nn.Module):

    default_loss = "sparse_categorical_crossentropy"
    default_metrics = ("accuracy",)

    def __init__(self, vocab, hidden_size, n_block, n_head,
                 intermediate_size, max_position_len, hidden_drop,
                 attn_drop, attn_impl, compute_dtype, device, with_pooler,
                 remat, remat_policy):
        super().__init__()
        self.device_ = resolve_device(device)
        self.hidden_drop = hidden_drop
        self.bert = TransformerEncoder(
            vocab=vocab, hidden_size=hidden_size, n_head=n_head,
            n_block=n_block, intermediate_size=intermediate_size,
            max_position_len=max_position_len, n_segments=2,
            embedding_dropout=hidden_drop, attn_dropout=attn_drop,
            residual_dropout=hidden_drop, with_pooler=with_pooler,
            attn_impl=attn_impl, compute_dtype=compute_dtype,
            remat=remat, remat_policy=remat_policy, device=self.device_)


class BERTClassifier(_BERT):
    """BERT encoder + pooled classification head: (input_ids [b, t],
    segment_ids, attention_mask [b, t]) -> logits [b, num_classes] f32.
    Dropout on the pooled output as in the JAX module."""

    def __init__(self, num_classes: int = 2, vocab: int = 30522,
                 hidden_size: int = 768, n_block: int = 12, n_head: int = 12,
                 intermediate_size: int = 3072, max_position_len: int = 512,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 attn_impl: str = "auto", compute_dtype=torch.bfloat16,
                 remat: bool = False, remat_policy=None, device=None):
        super().__init__(vocab, hidden_size, n_block, n_head,
                         intermediate_size, max_position_len, hidden_drop,
                         attn_drop, attn_impl, compute_dtype, device,
                         True, remat, remat_policy)
        self.classifier = nn.Linear(hidden_size, num_classes,
                                    device=self.device_)

    def forward(self, input_ids, segment_ids=None, attention_mask=None,
                impl: str = "auto", generator=None):
        _, pooled = self.bert(input_ids, segment_ids, None, attention_mask,
                              impl, generator)
        pooled = dropout(pooled, self.hidden_drop, self.training, generator)
        return self.classifier(pooled)


class BERTNER(_BERT):
    """Token-level tagging head: -> logits [b, t, num_entities] f32.
    Attention dropout at `hidden_drop` and dropout on the sequence
    output, as in the JAX module."""

    def __init__(self, num_entities: int = 9, vocab: int = 30522,
                 hidden_size: int = 768, n_block: int = 12, n_head: int = 12,
                 intermediate_size: int = 3072, max_position_len: int = 512,
                 hidden_drop: float = 0.1, attn_impl: str = "auto",
                 compute_dtype=torch.bfloat16, remat: bool = False,
                 remat_policy=None, device=None):
        super().__init__(vocab, hidden_size, n_block, n_head,
                         intermediate_size, max_position_len, hidden_drop,
                         hidden_drop, attn_impl, compute_dtype, device,
                         False, remat, remat_policy)
        self.ner_head = nn.Linear(hidden_size, num_entities,
                                  device=self.device_)

    def forward(self, input_ids, segment_ids=None, attention_mask=None,
                impl: str = "auto", generator=None):
        seq = self.bert(input_ids, segment_ids, None, attention_mask, impl,
                        generator)
        seq = dropout(seq, self.hidden_drop, self.training, generator)
        return self.ner_head(seq)


class BERTSQuAD(_BERT):
    """Span-extraction head: -> (start_logits, end_logits) [b, t] f32.
    Attention dropout at `hidden_drop`; no dropout on the span head's
    input, as in the JAX module."""

    default_metrics = ()

    def __init__(self, vocab: int = 30522, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12,
                 intermediate_size: int = 3072, max_position_len: int = 512,
                 hidden_drop: float = 0.1, attn_impl: str = "auto",
                 compute_dtype=torch.bfloat16, remat: bool = False,
                 remat_policy=None, device=None):
        super().__init__(vocab, hidden_size, n_block, n_head,
                         intermediate_size, max_position_len, hidden_drop,
                         hidden_drop, attn_impl, compute_dtype, device,
                         False, remat, remat_policy)
        self.span_head = nn.Linear(hidden_size, 2, device=self.device_)

    def forward(self, input_ids, segment_ids=None, attention_mask=None,
                impl: str = "auto", generator=None):
        logits = self.span_head(self.bert(input_ids, segment_ids, None,
                                          attention_mask, impl, generator))
        return logits[..., 0], logits[..., 1]
