"""Symbolic graph engine of the Keras-style API (counterpart of
analytics_zoo_tpu/keras/engine.py).

A layer call records a `Node` in a small Python DAG; `Model(inputs,
outputs)` sorts it and runs the whole graph as ONE torch module
(`models.GraphModule`).  Layers are config holders, in two kinds:

* a layer with parameters implements `build(*xs)`, which makes its
  torch module for the first batch's tensors `xs` (so every input
  width is known, as flax infers them at `init`), and `apply(m, *xs,
  training, generator, impl)`;
* a stateless layer implements `call(*xs, training)` on tensors, and
  `call(*xs, training, generator)` if it `draws` (a random layer,
  from the graph's generator in training).

The layer's `name` is the name its module is registered under in the
graph module (`module_name`; `TimeDistributed` takes its inner
layer's), so the weight converter (`convert.keras_from_flax`) finds each
layer's flax subtree by it.  Names come from per-class counters
(`dense_1`, `embedding_2`, ...) in the same order as the JAX package's.
`Input(shape=)` is documentation only: the shapes come from the data.
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_name_counters: Dict[str, "itertools.count"] = defaultdict(
    lambda: itertools.count(1))


def _auto_name(prefix: str) -> str:
    return f"{prefix}_{next(_name_counters[prefix])}"


def reset_name_scope():
    _name_counters.clear()


def _binary(fn, opname: str, a, b):
    from analytics_zoo_tpu_torch.keras.layers.merge import _BinaryOp
    return _BinaryOp(fn, opname)([a, b])


class SymTensor:
    """A symbolic tensor: the output of a Node (layer invocation), with
    the arithmetic of the reference's autograd `Variable`."""

    def __init__(self, node: "Node", index: int = 0):
        self.node = node
        self.index = index

    def __add__(self, other):
        return _binary(torch.add, "add", self, _lift(other))

    __radd__ = __add__

    def __sub__(self, other):
        return _binary(torch.subtract, "sub", self, _lift(other))

    def __rsub__(self, other):
        return _binary(torch.subtract, "rsub", _lift(other), self)

    def __mul__(self, other):
        return _binary(torch.multiply, "mul", self, _lift(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary(torch.divide, "div", self, _lift(other))

    def __rtruediv__(self, other):
        return _binary(torch.divide, "rdiv", _lift(other), self)

    def __pow__(self, other):
        return _binary(torch.pow, "pow", self, _lift(other))

    def __neg__(self):
        from analytics_zoo_tpu_torch.keras.layers.merge import _UnaryOp
        return _UnaryOp(torch.negative, "neg")(self)


def _lift(x):
    if isinstance(x, SymTensor):
        return x
    from analytics_zoo_tpu_torch.keras.layers.merge import _Const
    return _Const(x)()


class Node:
    def __init__(self, layer: "Layer", inputs: List[SymTensor]):
        self.layer = layer
        self.inputs = inputs


class InputNode(Node):
    def __init__(self, name: str, shape: Optional[Tuple[int, ...]]):
        super().__init__(layer=None, inputs=[])
        self.name = name
        self.shape = shape


def Input(shape: Optional[Sequence[int]] = None, name: Optional[str] = None
          ) -> SymTensor:
    """Declare a graph input.  `shape` excludes the batch dim and is
    only documentation: the real shapes come from the data."""
    name = name or _auto_name("input")
    return SymTensor(InputNode(name, tuple(shape) if shape else None))


class Layer:
    """Base class.  Subclasses take `name` and implement either
    `build()` + `apply()` (parameters) or `call()` (stateless)."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or _auto_name(type(self).__name__.lower())

    #: whether `call` takes the graph's generator (a random layer)
    draws = False

    #: outputs of the layer; > 1 makes the symbolic call return a tuple
    #: of SymTensors (e.g. BERT -> (sequence, pooled))
    n_outputs = 1

    @property
    def module_name(self) -> str:
        """The name the layer's module is registered under."""
        return self.name

    # -- one of these two routes --
    def build(self, *xs) -> Optional[torch.nn.Module]:
        """The layer's module for the first batch's inputs `xs`, on their
        device, or None for a stateless layer."""
        return None

    def apply(self, m, *xs, training: bool = False, generator=None,
              impl: str = "auto"):
        """The layer's output from its module (by default `m(*xs)`)."""
        return m(*xs)

    def call(self, *xs, training: bool = False):
        raise NotImplementedError(
            f"{type(self).__name__} must implement call() or build()")

    def __call__(self, x):
        """Symbolic application.  `x` is a SymTensor or a list of them."""
        inputs = list(x) if isinstance(x, (list, tuple)) else [x]
        for t in inputs:
            if not isinstance(t, SymTensor):
                raise TypeError(
                    f"layer {self.name} called on non-symbolic input "
                    f"{type(t).__name__}; use Input(...) to start a graph")
        node = Node(self, inputs)
        if self.n_outputs == 1:
            return SymTensor(node)
        return tuple(SymTensor(node, i) for i in range(self.n_outputs))


def topo_sort(outputs: List[SymTensor]) -> List[Node]:
    """Deterministic post-order DFS over the DAG."""
    seen: Dict[int, Node] = {}
    order: List[Node] = []

    def visit(node: Node):
        if id(node) in seen:
            return
        seen[id(node)] = node
        for t in node.inputs:
            visit(t.node)
        order.append(node)

    for t in outputs:
        visit(t.node)
    return order
