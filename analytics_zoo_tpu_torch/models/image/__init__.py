"""Image models of the port (counterpart of
analytics_zoo_tpu/models/image/): classification and object
detection."""
