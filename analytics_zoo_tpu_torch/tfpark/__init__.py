"""tfpark compatibility namespace on the port (counterpart of
analytics_zoo_tpu/tfpark/__init__.py; reference `pyzoo/zoo/tfpark/`, the
TF1-era distributed API).

Each reference name resolves to the port's equivalent, and names whose
machinery no longer exists raise with the replacement spelled out.

| reference | here |
|---|---|
| `TFNet.from_export_folder / from_session` | `load_tf_graph(path)` / `Net.load_tf(path)`, returning the `TFNet` re-exported here (`pipeline/tf_graph.py`) |
| `TFPredictor` | `InferenceModel` (`serving/inference_model.py`) |
| `GANEstimator` | `GANEstimator` (`orca/learn/gan.py`) |
| `BERTClassifier / BERTNER / BERTSQuAD` | same names (`models/bert.py`) |
| `KerasModel / TFEstimator / TFOptimizer` | `orca.learn.Estimator` (from_torch / from_keras / from_onnx) |
| `ZooOptimizer` | `orca.learn.optimizers` |
| `TFDataset` | `XShards` / data-creator functions (`orca/data`) |
"""

from analytics_zoo_tpu_torch.models.bert import (  # noqa: F401
    BERTClassifier,
    BERTNER,
    BERTSQuAD,
)
from analytics_zoo_tpu_torch.orca.learn.gan import GANEstimator  # noqa: F401
from analytics_zoo_tpu_torch.pipeline.tf_graph import (  # noqa: F401
    TFNet,
    load_tf_graph,
)
from analytics_zoo_tpu_torch.serving.inference_model import (  # noqa: F401
    InferenceModel as TFPredictor,
)

_REPLACED = {
    "KerasModel": "orca.learn.Estimator.from_keras / from_torch",
    "TFEstimator": "orca.learn.Estimator (uniform fit/evaluate/predict)",
    "TFOptimizer": "orca.learn.Estimator (the one training engine)",
    "ZooOptimizer": "orca.learn.optimizers (the optimizer registry)",
    "TFDataset": "orca.data.XShards or data-creator functions",
}


def __getattr__(name):
    if name in _REPLACED:
        raise AttributeError(
            f"tfpark.{name} is TF1-runtime machinery that the port does "
            f"not carry; use analytics_zoo_tpu_torch.{_REPLACED[name]} "
            "instead (see docs/migration-from-analytics-zoo.md)")
    raise AttributeError(name)
