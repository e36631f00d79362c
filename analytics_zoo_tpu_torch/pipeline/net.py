"""Net loaders and graph surgery on torch (counterpart of
analytics_zoo_tpu/pipeline/net.py; reference
`pyzoo/zoo/pipeline/api/net/{graph_net,net_load}.py`).

The import paths are ONNX (`pipeline/onnx/`), torch itself
(`load_torch`: a module, or a `torch.save`d module file, already is the
port's model), Caffe caffemodels (`pipeline/caffe_graph.py`) and TF1
frozen GraphDefs (`pipeline/tf_graph.py`), all read by the repo's own
protobuf wire decoder.  `load_bigdl` is absent, as in JAX: BigDL's JVM
serialization schema ships only inside the BigDL jar, and the supported
route is ONNX (docs/migration-from-analytics-zoo.md).  Graph surgery
works on the decoded ONNX graph: `new_graph` backward-slices it to new
output tensors, `freeze` makes every initializer a constant.  Each
loader takes `device` (None = the CUDA card, raising without one).
"""

from __future__ import annotations

import copy
from typing import List, Sequence

from analytics_zoo_tpu_torch.pipeline.onnx.onnx_loader import OnnxModule


class Net:
    @staticmethod
    def load_onnx(path_or_bytes, device=None):
        """-> (OnnxModule on `device`, decoded Model)."""
        from analytics_zoo_tpu_torch.pipeline.onnx.onnx_loader import (
            load_onnx)
        return load_onnx(path_or_bytes, device=device)

    @staticmethod
    def load_torch(module_or_path, device=None):
        """A torch.nn.Module (or a `torch.save`d module file) ->
        (the module on `device`, its parameters, its buffers): the
        triple JAX's returns (flax module, params, model_state), with
        the parameters and buffers as name -> tensor dicts.  A file is
        unpickled, as `torch.load` of a whole module must be: load only
        files this program or its users wrote."""
        import torch

        from analytics_zoo_tpu_torch.device import resolve_device
        device = resolve_device(device)
        if isinstance(module_or_path, str):
            module_or_path = torch.load(module_or_path, map_location=device,
                                        weights_only=False)
        module = module_or_path.to(device)
        return (module, dict(module.named_parameters()),
                dict(module.named_buffers()))

    @staticmethod
    def load_caffe(def_path: str, model_path: str, outputs=None,
                   device=None):
        """Load a Caffe model for inference (reference Net.load_caffe /
        CaffeLoader.scala): the binary caffemodel's topology and weights
        as a `CaffeNet`; `def_path` is consulted only for the deploy
        `input:` declaration."""
        from analytics_zoo_tpu_torch.pipeline.caffe_graph import load_caffe
        return load_caffe(def_path, model_path, outputs=outputs,
                          device=device)

    @staticmethod
    def load_tf(path: str, outputs=None, device=None):
        """Load a frozen TF1 GraphDef `.pb` for inference (reference
        net_load.py:30 Net.load_tf / TFNet.scala).  Returns a TFNet:
        `predict(*arrays)` feeds the placeholders."""
        from analytics_zoo_tpu_torch.pipeline.tf_graph import load_tf_graph
        return load_tf_graph(path, outputs=outputs, device=device)


class GraphNet:
    """Surgery over a decoded ONNX model (reference GraphNet.new_graph /
    freeze semantics on BigDL graphs)."""

    def __init__(self, model):
        self.model = model
        self._frozen = False

    def new_graph(self, output_names: Sequence[str]) -> "GraphNet":
        """Re-root the graph at intermediate tensors: keeps only the
        backward slice that produces `output_names` (reference
        GraphNet.new_graph)."""
        g = self.model.graph
        produced = {o: n for n in g.nodes for o in n.outputs}
        for name in output_names:
            if name not in produced and name not in g.initializers \
                    and name not in [i for i, _ in g.inputs]:
                raise ValueError(f"unknown tensor '{name}'")
        needed: List = []
        seen = set()
        stack = list(output_names)
        while stack:
            t = stack.pop()
            node = produced.get(t)
            if node is None or id(node) in seen:
                continue
            seen.add(id(node))
            needed.append(node)
            stack.extend(node.inputs)
        order = {id(n): i for i, n in enumerate(g.nodes)}
        needed.sort(key=lambda n: order[id(n)])

        new_model = copy.copy(self.model)
        new_graph = copy.copy(g)
        new_graph.nodes = needed
        new_graph.outputs = list(output_names)
        # drop initializers the slice no longer touches
        used = {i for n in needed for i in n.inputs}
        new_graph.initializers = {k: v for k, v in g.initializers.items()
                                  if k in used}
        new_model.graph = new_graph
        return GraphNet(new_model)

    def freeze(self) -> "GraphNet":
        """Make every initializer a constant (no trainable params): the
        imported net becomes a fixed feature extractor (reference
        GraphNet.freeze)."""
        new = GraphNet(self.model)
        new._frozen = True
        return new

    def to_module(self, device=None):
        """An `OnnxModule` of the graph on `device`; after `freeze`, a
        `_FrozenOnnx`."""
        if self._frozen:
            return _FrozenOnnx(self.model, device=device)
        return OnnxModule(self.model, device=device)


class _FrozenOnnx(OnnxModule):
    """The graph with ALL initializers as constants: no `nn.Parameter`
    (a fixed feature extractor; nothing to train).  Each constant
    reaches the device once, on first use."""

    def __init__(self, model, device=None):
        super().__init__(model, device=device, frozen=True)
