"""Pipeline APIs: model import (ONNX, TF1 frozen graphs, Caffe) and net
utilities, on torch (counterpart of analytics_zoo_tpu/pipeline/)."""
