"""PyTorch + CUDA port of `analytics_zoo_tpu`, for one NVIDIA H100.

The JAX package beside this one is the reference: every module here
mirrors the module path of its JAX counterpart, and the tests hold the
two against each other on the same inputs.  This package imports
`torch` and never `jax`, nor anything of `analytics_zoo_tpu`: what it
needs from there it keeps as its own copy.

Every TPU kernel of a ported path is a kernel written by hand for
Hopper (`ops/kernels/`, CUDA sources under `csrc/`), with its plain
PyTorch version beside it.  A CUDA tensor goes to the kernel or raises;
a CPU tensor goes to the plain version.

Entry points run on `cuda` unless the caller passes `device="cpu"`;
without a card and without that argument they raise
(`resolve_device`).

Ported so far: the paged-KV generation serving path
(`serving.generation`: `CausalLM`, `GenerationEngine`), BERT
classification serving (`serving.inference_model`) and fine-tuning
(`orca.learn.Estimator`), recommendation training
(`models.recommendation`) from the DEVICE data store
(`common.context.OrcaContext`), and Orca's data path (`orca.data`:
XShards, the DISK tier, the pandas readers; DataFrame and XShards input
to the Estimator, staged to the card through pinned double buffering),
the HTTP serving front end (`serving`), int8 weight serving
(`serving.quantize`), the image models (`models.image`: ResNet,
Inception-v1, MobileNetV2, VGG-16, SSD, Faster R-CNN) with the image
feature pipeline (`feature`) and readers (`orca.data.image`), the rest
of the model zoo (text classification, KNRM, Seq2Seq, the anomaly
detector, the VAE, `GANEstimator`, `InferenceEstimator`, pretrained
BERT weights), the Keras-style API (`keras`, `keras2`,
`Estimator.from_keras`), the model importers (`pipeline`: ONNX with
`Estimator.from_onnx`, TF1 frozen graphs, Caffe, `Net`; `tfpark`), the
runtime entry points (`init_orca_context`, `init_nncontext`,
`stop_orca_context`, re-exported here as in the JAX package), and
Chronos (`chronos`: `TSDataset` and `XShardsTSDataset`, the TCN, LSTM,
Seq2Seq, MTNet, TCMF, ARIMA and Prophet forecasters, `AutoTSEstimator`
with its classical legs, `TSPipeline`, the deprecated AutoTS API, the
anomaly detectors, the DoppelGANger simulator) over the AutoML search
engine (`orca.automl`, with the native GBDT behind AutoXGBoost) and the
device lease (`common.device_lease`).
"""

from analytics_zoo_tpu_torch.common.context import (  # noqa: F401
    OrcaContext,
    init_nncontext,
    init_orca_context,
    stop_orca_context,
)
from analytics_zoo_tpu_torch.device import resolve_device  # noqa: F401

__all__ = ["OrcaContext", "init_nncontext", "init_orca_context",
           "resolve_device", "stop_orca_context"]
