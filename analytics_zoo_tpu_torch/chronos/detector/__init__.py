"""Chronos's detectors (counterpart of
analytics_zoo_tpu/chronos/detector/)."""
