"""Text classifier (counterpart of
analytics_zoo_tpu/models/textclassification/text_classifier.py:16-42;
reference scala `models/textclassification/TextClassifier.scala`): a
token embedding, a CNN, LSTM or GRU encoder, then `fc` (128, ReLU) and
a `class_num` head.  All f32.

Token ids are clipped to [0, vocab_size - 1] as JAX clips them.  The
"cnn" encoder is flax's `nn.Conv(encoder_output_dim, (5,))`: a 1-D conv
with "SAME" padding (2 and 2), ReLU, then the max over time; "lstm" and
"gru" run `recurrent.lstm` / `recurrent.gru` over every position and
take the last one.  Dropout after the encoder draws its mask from the
`generator` the engine passes in training.  Weights come from a flax
tree through `convert.text_classifier_from_flax`.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.keras.layers.self_attention import dropout
from analytics_zoo_tpu_torch.models.common import recurrent
from analytics_zoo_tpu_torch.models.common.zoo_model import ZooModel
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Dense,
    _lecun_normal_,
)
from analytics_zoo_tpu_torch.models.recommendation.ncf import embedding

#: the CNN encoder's kernel width (flax pads it 2 and 2, "SAME")
KERNEL = 5


class TextClassifier(ZooModel, nn.Module):
    """token_ids [b, t] -> logits [b, class_num] f32."""

    def __init__(self, class_num: int, vocab_size: int = 20000,
                 embed_dim: int = 200, sequence_length: int = 500,
                 encoder: str = "cnn", encoder_output_dim: int = 256,
                 dropout: float = 0.2, device=None):
        nn.Module.__init__(self)
        self._config = dict(class_num=class_num, vocab_size=vocab_size,
                            embed_dim=embed_dim,
                            sequence_length=sequence_length, encoder=encoder,
                            encoder_output_dim=encoder_output_dim,
                            dropout=dropout)
        self.device_ = dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.encoder = encoder.lower()
        self.rate = dropout
        self.embed = embedding(vocab_size, embed_dim, dev)
        if self.encoder == "cnn":
            self.conv = nn.Conv1d(embed_dim, encoder_output_dim, KERNEL,
                                  padding=KERNEL // 2, device=dev)
            _lecun_normal_(self.conv.weight, embed_dim * KERNEL)
            nn.init.zeros_(self.conv.bias)
        elif self.encoder in ("lstm", "gru"):
            self.cell = recurrent.make(self.encoder, embed_dim,
                                       encoder_output_dim, dev)
        else:
            raise ValueError(f"unknown encoder '{encoder}'")
        self.fc = Dense(encoder_output_dim, 128, device=dev)
        self.head = Dense(128, class_num, device=dev)

    def flax_layout(self):
        """(to_flax(state_dict), from_flax(tree)): the JAX module's
        param tree (`convert.text_classifier_to_flax` and
        `text_classifier_from_flax`)."""
        from analytics_zoo_tpu_torch import convert
        return (convert.text_classifier_to_flax,
                convert.text_classifier_from_flax)

    def forward(self, token_ids, generator=None):
        ids = token_ids.long().clamp(0, self.vocab_size - 1)
        x = self.embed(ids).float()
        if self.encoder == "cnn":
            h = F.relu(self.conv(x.transpose(1, 2))).amax(dim=2)
        else:
            h = self.cell(x)[0][:, -1]
        h = dropout(h, self.rate, self.training, generator)
        return self.head(F.relu(self.fc(h)))
