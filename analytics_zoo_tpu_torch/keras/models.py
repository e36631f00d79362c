"""Model / Sequential (counterpart of analytics_zoo_tpu/keras/models.py):
the compile / fit / evaluate / predict surface over ONE torch module.

`to_torch()` gives the graph as a `GraphModule`, the counterpart of the
JAX `_GraphModule`: every layer's module is registered on it under the
layer's name (a shared layer is one module, called at each of its
nodes), so its state_dict reads `dense_1.weight`, `bert_1.blocks.0...`.
flax infers every input width at `init` from the first batch; here a
`GraphModule` is built the same way: `build(*sample)` runs the graph
once on the sample in eval mode, without gradients, making each layer's
module for the tensors that reach it, its parameters drawn from `seed`
(`torch.random.fork_rng`: the caller's own random state is left as it
was).  `Estimator.from_keras` builds on the first batch of whichever of
`fit`, `evaluate` or `predict` comes first.  The forward takes the
graph's inputs, the `generator` its random layers draw from in training
(the Estimator's seeded one) and `impl` ("auto", or "reference" for the
kernels' plain versions).

A model runs on the CUDA card unless given `device=` ("cpu" on a
machine without one); without a card it raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.keras.engine import (
    InputNode, Layer, SymTensor, topo_sort)


class GraphModule(nn.Module):
    """The whole Keras graph as ONE torch module (module docstring)."""

    def __init__(self, net: "KerasNet", device=None):
        super().__init__()
        self.net = net
        self.device = resolve_device(device)
        self.built = False
        self._building = False
        self._owners: Dict[str, int] = {}

    def module_of(self, layer: Layer, xs) -> Optional[nn.Module]:
        """The layer's module; while building, made for `xs` on first
        sight."""
        key = layer.module_name
        if key in self._modules:
            if self._building and self._owners[key] != id(layer):
                raise ValueError(f"two layers are named {key!r}")
            return self._modules[key]
        if not self._building:
            return None
        m = layer.build(*xs)
        if m is not None:
            if "." in key or hasattr(self, key):
                raise ValueError(f"layer name {key!r} cannot name a module")
            self.add_module(key, m.eval())   # built in eval mode
            self._owners[key] = id(layer)
        return m

    def build(self, *sample, seed: int = 0) -> "GraphModule":
        """Make every layer's module for the sample inputs (numpy arrays
        or tensors, a row or more each), its parameters drawn from
        `seed`.  A built module is left as it is."""
        if self.built:
            return self
        xs = tuple(torch.as_tensor(np.ascontiguousarray(a)
                                   if isinstance(a, np.ndarray) else a,
                                   device=self.device) for a in sample)
        devices = [self.device] if self.device.type == "cuda" else []
        self._building = True
        try:
            with torch.random.fork_rng(devices=devices), torch.no_grad():
                torch.manual_seed(seed)
                self.net._execute(self, xs, False, None, "auto")
        finally:
            self._building = False
        self._owners.clear()
        self.built = True
        self.train(self.training)
        return self

    def forward(self, *inputs, generator=None, impl: str = "auto"):
        if not self.built:
            raise RuntimeError("build(*sample) the graph module before "
                               "calling it (Estimator.from_keras builds "
                               "it on the first batch)")
        return self.net._execute(self, inputs, self.training, generator,
                                 impl)


def _run_layer(gm: GraphModule, layer: Layer, xs, training, generator,
               impl):
    if not xs:                          # a constant lifted into the graph
        return layer.call(training=training, device=gm.device)
    m = gm.module_of(layer, xs)
    if m is not None:
        return layer.apply(m, *xs, training=training, generator=generator,
                           impl=impl)
    if layer.draws:
        return layer.call(*xs, training=training, generator=generator)
    return layer.call(*xs, training=training)


class KerasNet:
    """compile / fit / evaluate / predict shared by Model and Sequential."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._loss = None
        self._optimizer = None
        self._metrics = None
        self._estimator = None
        self.model_dir = None

    # -- lowering --
    def to_torch(self) -> GraphModule:
        """A new, unbuilt graph module of this model."""
        return GraphModule(self, self.device)

    def _execute(self, gm: GraphModule, inputs, training, generator, impl):
        raise NotImplementedError

    # -- training surface --
    def compile(self, optimizer=None, loss=None, metrics=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics
        self._estimator = None
        return self

    def set_checkpoint(self, path: str):
        self.model_dir = path

    def _ensure_estimator(self):
        # no loss required: an uncompiled model can still predict
        if self._estimator is None:
            from analytics_zoo_tpu_torch.orca.learn.estimator import (
                Estimator)
            self._estimator = Estimator.from_keras(
                self, model_dir=self.model_dir)
        return self._estimator

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 1,
            epochs: Optional[int] = None, validation_data=None, **kwargs):
        if self._loss is None:
            raise RuntimeError("call compile(optimizer, loss) before fit")
        data = x if y is None else (x, y)
        est = self._ensure_estimator()
        est.fit(data, epochs=epochs or nb_epoch, batch_size=batch_size,
                validation_data=validation_data, **kwargs)
        return self

    def evaluate(self, x, y=None, batch_size: int = 32, **kwargs):
        data = x if y is None else (x, y)
        return self._ensure_estimator().evaluate(
            data, batch_size=batch_size, **kwargs)

    def predict(self, x, batch_size: int = 32, **kwargs):
        return self._ensure_estimator().predict(
            x, batch_size=batch_size, **kwargs)

    def get_weights(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The trained weights by layer module name, {name: {entry:
        tensor}} (JAX's params tree by layer); empty before the first
        batch."""
        out: Dict[str, Dict[str, Any]] = {}
        gm = self._ensure_estimator().get_model()
        for k, v in gm.state_dict().items():
            layer, _, entry = k.partition(".")
            out.setdefault(layer, {})[entry] = v
        return out

    # -- introspection --
    def layers(self) -> List[Layer]:
        raise NotImplementedError

    def summary(self) -> str:
        lines = [f"{type(self).__name__}:"]
        for layer in self.layers():
            lines.append(f"  {layer.name} ({type(layer).__name__})")
        s = "\n".join(lines)
        print(s)
        return s


class Model(KerasNet):
    """Functional graph model."""

    def __init__(self, input, output, name: Optional[str] = None,
                 device=None):
        super().__init__(device)
        self.inputs: List[SymTensor] = (
            list(input) if isinstance(input, (list, tuple)) else [input])
        self.outputs: List[SymTensor] = (
            list(output) if isinstance(output, (list, tuple)) else [output])
        self._single_output = not isinstance(output, (list, tuple))
        self.name = name or "model"
        self._order = topo_sort(self.outputs)
        input_ids = {id(t.node) for t in self.inputs}
        for node in self._order:
            if isinstance(node, InputNode) and id(node) not in input_ids:
                raise ValueError(
                    f"graph references Input '{node.name}' that is not in "
                    "the model's input list")

    def _execute(self, gm, inputs, training, generator, impl):
        if len(inputs) != len(self.inputs):
            raise ValueError(
                f"model expects {len(self.inputs)} inputs, got {len(inputs)}")
        env = {}
        for sym, arr in zip(self.inputs, inputs):
            env[id(sym.node)] = (arr,)
        for node in self._order:
            if isinstance(node, InputNode):
                continue
            xs = [env[id(t.node)][t.index] for t in node.inputs]
            y = _run_layer(gm, node.layer, xs, training, generator, impl)
            env[id(node)] = y if isinstance(y, tuple) else (y,)
        outs = tuple(env[id(t.node)][t.index] for t in self.outputs)
        return outs[0] if self._single_output else outs

    def layers(self):
        return [n.layer for n in self._order if n.layer is not None]


class Sequential(KerasNet):
    """Linear stack."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 name: Optional[str] = None, device=None):
        super().__init__(device)
        self._layers: List[Layer] = list(layers or [])
        self.name = name or "sequential"

    def add(self, layer: Layer) -> "Sequential":
        self._layers.append(layer)
        self._estimator = None
        return self

    def _execute(self, gm, inputs, training, generator, impl):
        if len(inputs) != 1:
            raise ValueError("Sequential models take exactly one input")
        x = inputs[0]
        for layer in self._layers:
            x = _run_layer(gm, layer, [x], training, generator, impl)
        return x

    def layers(self):
        return list(self._layers)
