"""Utilities (counterpart of analytics_zoo_tpu/utils/, the part the
training summaries need, copied)."""
