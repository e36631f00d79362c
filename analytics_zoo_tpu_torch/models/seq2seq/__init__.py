"""Seq2Seq of the port (counterpart of analytics_zoo_tpu/models/seq2seq/)."""

from analytics_zoo_tpu_torch.models.seq2seq.seq2seq import Seq2Seq  # noqa: F401,E501
