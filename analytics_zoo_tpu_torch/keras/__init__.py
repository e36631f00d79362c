"""Keras-style layers of the port (counterpart of analytics_zoo_tpu/keras)."""
