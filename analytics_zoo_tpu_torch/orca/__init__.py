"""Orca, the training side of the port (counterpart of
analytics_zoo_tpu/orca/)."""
