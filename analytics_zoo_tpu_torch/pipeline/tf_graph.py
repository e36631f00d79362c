"""TF1 frozen-graph (GraphDef `.pb`) importer on torch (counterpart of
analytics_zoo_tpu/pipeline/tf_graph.py; reference `Net.load_tf` /
`TFNet.scala`).

No tensorflow anywhere: the GraphDef protobuf is decoded with the
repo's wire-format reader, constants come out as numpy arrays (a
DT_BFLOAT16 constant as a `torch.bfloat16` CPU tensor made from its bit
patterns: numpy has no bfloat16), and the op graph is interpreted with
torch ops on the device the net was built for.  Coverage is the JAX
importer's: dense / conv / pool / batchnorm / elementwise / reduction /
shape inference ops; anything else raises NotImplementedError naming
the op.

Frozen-graph contract (the reference TFNet's): every variable is folded
to a Const, `Placeholder` nodes are the inputs, fed by name, and the
outputs default to the nodes nothing else consumes.

Layout: data stays NHWC as in TF.  A conv or pool sees the NHWC tensor
through a permuted view (NCHW shape, channels-last memory), so cuDNN
reads it in place; TF's SAME padding (the odd pixel at the end, its
size set by the stride) is padded explicitly where it is asymmetric.
A depthwise filter [kh, kw, in, mult] becomes a grouped conv with
output channel c * mult + m.  Shape-like arguments (axes, dims, pads,
permutations) must be graph constants, as JAX's jitted function needs
them: a run-time value raises NotImplementedError.  Ops that JAX writes
as Python operators (Add, Mul, MatMul, Neg, ...) keep two constant
operands on the host, so their results stay static, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.pipeline.onnx.onnx_loader import (
    conv_nd,
    padded_max,
    padded_mean,
    read_bytes,
    same_pads,
    to_torch,
)
from analytics_zoo_tpu_torch.utils.tf_example import (
    packed_bools,
    packed_floats,
    packed_ints,
    to_signed,
    to_str as _str,
    walk_fields as _fields,
)

#: TF DataType enum -> numpy dtype (the inference-relevant subset);
#: DT_BFLOAT16 (14) is decoded to torch.bfloat16 from its uint16 bits
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
           5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
           14: np.uint16, 19: np.float16}
_BFLOAT16 = 14


def _parse_shape(buf) -> List[int]:
    dims = []
    for fnum, _, val in _fields(buf):
        if fnum == 2:  # Dim
            size = 0
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    size = to_signed(v2) if isinstance(v2, int) else 0
            dims.append(size)
    return dims


def _parse_tensor(buf):
    dtype_num, shape, content = 1, [], b""
    f32s: List[float] = []
    i64s: List[int] = []
    i32s: List[int] = []
    bools: List[bool] = []
    f64s: List[float] = []
    halves: List[int] = []
    for fnum, wt, val in _fields(buf):
        if fnum == 1:
            dtype_num = val
        elif fnum == 2:
            shape = _parse_shape(val)
        elif fnum == 4:
            content = val
        elif fnum == 5:   # float_val (packed or repeated)
            f32s.extend(packed_floats(val, wt))
        elif fnum == 6:
            if wt == 2:
                f64s.extend(np.frombuffer(val, "<f8").tolist())
            else:
                f64s.append(np.frombuffer(val, "<f8")[0])
        elif fnum == 7:   # int_val
            i32s.extend(packed_ints(val, wt))
        elif fnum == 10:  # int64_val
            i64s.extend(packed_ints(val, wt))
        elif fnum == 11:  # bool_val
            bools.extend(packed_bools(val, wt))
        elif fnum == 13:  # half_val: fp16/bf16 bit patterns as int32s
            halves.extend(packed_ints(val, wt))
    dt = _DTYPES.get(dtype_num)
    if dt is None:
        raise NotImplementedError(f"tensor dtype enum {dtype_num}")
    size = int(np.prod(shape)) if shape else 1
    vals = f32s or f64s or i32s or i64s or bools
    if dtype_num == _BFLOAT16 and not len(content) and not halves and vals:
        # typed values rounded to bfloat16 (round to nearest even)
        arr = torch.tensor(vals, dtype=torch.float32).to(torch.bfloat16)
        if arr.numel() == 1 and size > 1:    # scalar splat encoding
            arr = arr.expand(size).clone()
    else:
        if len(content):
            arr = np.frombuffer(content, dt)
        elif halves:
            # typed 16-bit values ride half_val as raw bit patterns
            arr = np.asarray(halves, np.uint16).view(dt)
        elif vals:
            arr = np.asarray(vals, dt)
            if arr.size == 1 and size > 1:    # scalar splat encoding
                arr = np.full(size, arr[0], dt)
        else:
            arr = np.zeros(size, dt)
        if dtype_num == _BFLOAT16:
            arr = torch.from_numpy(np.array(arr, np.uint16).view(
                np.int16)).view(torch.bfloat16)
    n = arr.numel() if isinstance(arr, torch.Tensor) else arr.size
    return arr.reshape(shape) if shape else (
        arr.reshape(()) if n == 1 else arr)


def _parse_attr(buf) -> Dict[str, Any]:
    """AttrValue -> {'s'|'i'|'f'|'b'|'type'|'shape'|'tensor'|'list': v}"""
    out: Dict[str, Any] = {}
    for fnum, wt, val in _fields(buf):
        if fnum == 2:
            out["s"] = bytes(val).decode("utf-8", "replace")
        elif fnum == 3:
            out["i"] = to_signed(val)
        elif fnum == 4:
            out["f"] = float(np.frombuffer(val, "<f4")[0])
        elif fnum == 5:
            out["b"] = bool(val)
        elif fnum == 6:
            out["type"] = val
        elif fnum == 7:
            out["shape"] = _parse_shape(val)
        elif fnum == 8:
            out["tensor"] = _parse_tensor(val)
        elif fnum == 1:   # ListValue
            lst: Dict[str, list] = {"s": [], "i": [], "f": [], "b": []}
            for f2, wt2, v2 in _fields(val):
                if f2 == 2:
                    lst["s"].append(_str(v2))
                elif f2 == 3:
                    lst["i"].extend(packed_ints(v2, wt2))
                elif f2 == 4:
                    lst["f"].extend(packed_floats(v2, wt2))
                elif f2 == 5:
                    lst["b"].extend(packed_bools(v2, wt2))
            out["list"] = lst
    return out


def _parse_node(buf) -> Dict[str, Any]:
    node = {"name": "", "op": "", "inputs": [], "attrs": {}}
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            node["name"] = _str(val)
        elif fnum == 2:
            node["op"] = _str(val)
        elif fnum == 3:
            node["inputs"].append(_str(val))
        elif fnum == 5:   # attr map entry
            key, attr = "", {}
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    key = _str(v2)
                elif f2 == 2:
                    attr = _parse_attr(v2)
            node["attrs"][key] = attr
    return node


def parse_graphdef(data) -> List[Dict[str, Any]]:
    """GraphDef bytes -> node dicts {name, op, inputs, attrs}; a
    constant's `tensor_content` is a numpy view of `data`."""
    return [_parse_node(val) for fnum, _, val in _fields(memoryview(data))
            if fnum == 1]


# ---------------------------------------------------------------------
# interpreter
# ---------------------------------------------------------------------

_IDENTITIES = ("Identity", "StopGradient", "PreventGradient",
               "CheckNumerics")


def _pad(attrs) -> str:
    return attrs.get("padding", {}).get("s", "VALID")


def _ints(attrs, key, default=None):
    a = attrs.get(key)
    if a is None:
        return default
    return list(a.get("list", {}).get("i", default or []))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _is_host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic)) or np.isscalar(v)


class TFNet:
    """A frozen TF graph as a function of torch tensors on `device`
    (None = the CUDA card).  `predict(*arrays)` feeds the placeholders
    in graph order and returns numpy; `_eval(*tensors)` returns
    tensors."""

    def __init__(self, nodes: List[Dict[str, Any]],
                 outputs: Optional[Sequence[str]] = None, device=None):
        self.device = resolve_device(device)
        self.nodes = {n["name"]: n for n in nodes}
        self.order = self._topo_sort(nodes)
        self.input_names = [n["name"] for n in nodes
                            if n["op"] in ("Placeholder", "PlaceholderV2")]
        if outputs is None:
            consumed = {self._base(i) for n in nodes
                        for i in n["inputs"]}
            outputs = [n["name"] for n in nodes
                       if n["name"] not in consumed
                       and n["op"] not in ("NoOp", "Placeholder",
                                           "PlaceholderV2", "Const")]
        self.output_names = list(outputs)
        #: device copies of constants and of weights laid out for torch,
        #: made once, keyed by node name
        self._cache: Dict[Any, torch.Tensor] = {}
        #: nodes whose value is a graph constant: Consts and identities
        #: of them (a frozen graph reads weights through `Identity`)
        self._const_like = set()
        for n in self.order:
            refs = [r for r in n["inputs"] if not r.startswith("^")]
            if n["op"] == "Const" or (
                    n["op"] in _IDENTITIES and refs and ":" not in refs[0]
                    and self._base(refs[0]) in self._const_like):
                self._const_like.add(n["name"])

    @staticmethod
    def _base(ref: str) -> str:
        ref = ref.lstrip("^")
        return ref.split(":")[0]

    def _topo_sort(self, nodes):
        """Iterative DFS: production frozen graphs chain >1000 nodes
        (ResNet-152-scale), past Python's recursion limit."""
        order: List[Dict[str, Any]] = []
        seen, instack = set(), set()
        byname = {n["name"]: n for n in nodes}
        for root in nodes:
            if root["name"] in seen:
                continue
            stack = [(root["name"], False)]
            while stack:
                name, done = stack.pop()
                if done:
                    instack.discard(name)
                    if name not in seen:
                        seen.add(name)
                        order.append(byname[name])
                    continue
                if name in seen:
                    continue
                if name in instack:
                    raise ValueError(f"cycle through {name}")
                instack.add(name)
                stack.append((name, True))
                for ref in byname[name]["inputs"]:
                    dep = self._base(ref)
                    if dep in byname and dep not in seen:
                        stack.append((dep, False))
        return order

    # -- evaluation ----------------------------------------------------

    @staticmethod
    def _static(v, what: str) -> np.ndarray:
        """Shape-like arguments (axes, dims, pads) must be graph
        constants: a value computed at run time raises."""
        if _is_host(v):
            return np.asarray(v)
        raise NotImplementedError(
            f"dynamic {what} (computed at runtime, not a Const) is not "
            "supported — the importer needs static shapes, as XLA does")

    def _resolve(self, env, ref):
        base = self._base(ref)
        idx = int(ref.split(":")[1]) if ":" in ref else 0
        v = env[base]
        return v[idx] if isinstance(v, tuple) else v

    def _t(self, v, key=None):
        """`v` as a tensor on the net's device; a constant (`key` its
        node's name) is copied there once."""
        if isinstance(v, torch.Tensor) and v.device == self.device:
            return v
        if key is not None and key in self._cache:
            return self._cache[key]
        t = (v.to(self.device) if isinstance(v, torch.Tensor)
             else to_torch(v, self.device))
        if key is not None:
            self._cache[key] = t
        return t

    def _prepared(self, key, v, fn):
        """fn(v as a tensor); made once where `key` names a constant."""
        if key is None:
            return fn(self._t(v))
        if key not in self._cache:
            self._cache[key] = fn(self._t(v)).contiguous()
        return self._cache[key]

    def _eval(self, *feeds):
        # feeds bind to placeholders BY NAME (input_names order):
        # topo-visit order need not match the GraphDef node order
        env: Dict[str, Any] = {
            name: self._t(x) for name, x in zip(self.input_names, feeds)}
        for node in self.order:
            op, attrs, name = node["op"], node["attrs"], node["name"]
            refs = [r for r in node["inputs"] if not r.startswith("^")]
            ins = [self._resolve(env, r) for r in refs]

            def const_key(i):
                base = self._base(refs[i])
                return base if base in self._const_like else None

            def t(i):
                # input i as a tensor; a constant's copy is kept
                return self._t(ins[i], const_key(i))

            if op in ("Placeholder", "PlaceholderV2"):
                continue   # bound by name above
            if op == "Const":
                # consts stay on the HOST: shape-like consumers read
                # them as static values
                env[name] = attrs["value"]["tensor"]
                continue
            if op in _IDENTITIES:
                env[name] = ins[0]
                continue
            if op == "NoOp":
                env[name] = ()
                continue
            host = all(_is_host(v) for v in ins)
            if op == "MatMul":
                a, b = ins if host else (t(0), t(1))
                if attrs.get("transpose_a", {}).get("b"):
                    a = a.T
                if attrs.get("transpose_b", {}).get("b"):
                    b = b.T
                env[name] = a @ b
                continue
            if op == "BiasAdd":
                if attrs.get("data_format", {}).get("s", "NHWC") != "NHWC":
                    raise NotImplementedError("BiasAdd NCHW")
                env[name] = ins[0] + ins[1] if host else t(0) + t(1)
                continue
            operators = {
                "Add": lambda a, b: a + b, "AddV2": lambda a, b: a + b,
                "Sub": lambda a, b: a - b, "Mul": lambda a, b: a * b,
                "RealDiv": lambda a, b: a / b,
                "SquaredDifference": lambda a, b: (a - b) ** 2,
                "Pow": lambda a, b: a ** b,
            }
            if op in operators:
                env[name] = (operators[op](*ins) if host
                             else operators[op](t(0), t(1)))
                continue
            if op in ("Maximum", "Minimum"):
                fn = torch.maximum if op == "Maximum" else torch.minimum
                env[name] = fn(t(0), t(1))
                continue
            if op == "Neg":
                env[name] = -ins[0] if host else -t(0)
                continue
            unary = {
                "Relu": F.relu,
                "Relu6": lambda x: torch.clamp(x, 0, 6),
                "Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
                "Exp": torch.exp, "Log": torch.log,
                "Sqrt": torch.sqrt, "Rsqrt": torch.rsqrt,
                "Square": torch.square, "Abs": torch.abs,
                "Floor": torch.floor, "Erf": torch.erf,
                "Softmax": lambda x: torch.softmax(x, dim=-1),
            }
            if op in unary:
                env[name] = unary[op](t(0))
                continue
            if op == "LeakyRelu":
                alpha = attrs.get("alpha", {}).get("f", 0.2)
                x = t(0)
                env[name] = torch.where(x >= 0, x, alpha * x)
                continue
            if op in ("Conv2D", "DepthwiseConv2dNative"):
                if attrs.get("data_format", {}).get("s", "NHWC") != "NHWC":
                    raise NotImplementedError(f"{op} NCHW")
                strides = _ints(attrs, "strides", [1, 1, 1, 1])
                dil = _ints(attrs, "dilations", [1, 1, 1, 1])
                x = t(0)
                kh, kw, cin, cout = ins[1].shape
                groups = 1
                if op == "DepthwiseConv2dNative":
                    # [h, w, cin, mult] -> OIHW [cin*mult, 1, h, w]:
                    # output channel c * mult + m, cin groups
                    groups, cout = cin, cin * cout

                    def layout(w, kh=kh, kw=kw, cout=cout):
                        return w.reshape(kh, kw, 1, cout).permute(3, 2, 0, 1)
                else:
                    def layout(w):
                        return w.permute(3, 2, 0, 1)    # HWIO -> OIHW
                key = const_key(1)
                w = self._prepared(key and (key, op), ins[1], layout)
                pairs = ([(0, 0), (0, 0)] if _pad(attrs) == "VALID"
                         else same_pads(x.shape[1:3], (kh, kw),
                                        strides[1:3], dil[1:3]))
                env[name] = _nhwc(conv_nd(_nchw(x), w, None, strides[1:3],
                                          pairs, dil[1:3], groups))
                continue
            if op in ("MaxPool", "AvgPool"):
                ks = _ints(attrs, "ksize", [1, 1, 1, 1])
                st = _ints(attrs, "strides", [1, 1, 1, 1])
                if ks[0] != 1 or ks[3] != 1 or st[0] != 1 or st[3] != 1:
                    raise NotImplementedError(
                        f"{op} over the batch or channel axis")
                x = t(0)
                pairs = ([(0, 0), (0, 0)] if _pad(attrs) == "VALID"
                         else same_pads(x.shape[1:3], ks[1:3], st[1:3]))
                flat = [pairs[1][0], pairs[1][1], pairs[0][0], pairs[0][1]]
                pool = padded_max if op == "MaxPool" else padded_mean
                env[name] = _nhwc(pool(_nchw(x), flat, ks[1:3], st[1:3]))
                continue
            if op in ("Mean", "Sum", "Max", "Min", "Prod"):
                axes = tuple(int(a) for a in self._static(
                    ins[1], "reduction axes").ravel().tolist())
                keep = attrs.get("keep_dims", {}).get("b", False)
                env[name] = _reduce(op, t(0), axes, keep)
                continue
            if op == "Reshape":
                shape = tuple(int(s) for s in self._static(
                    ins[1], "shape").ravel().tolist())
                env[name] = t(0).reshape(shape)
                continue
            if op == "Squeeze":
                dims = _ints(attrs, "squeeze_dims") or None
                x = t(0)
                env[name] = x.squeeze(tuple(dims)) if dims else x.squeeze()
                continue
            if op == "ExpandDims":
                env[name] = t(0).unsqueeze(
                    int(self._static(ins[1], "axis")))
                continue
            if op in ("Pad", "PadV2"):
                pads = self._static(ins[1], "paddings").tolist()
                cv = (float(self._static(ins[2], "pad value"))
                      if len(ins) > 2 else 0.0)
                flat = []
                for b, e in reversed(pads):
                    flat += [int(b), int(e)]
                env[name] = F.pad(t(0), flat, value=cv)
                continue
            if op == "ConcatV2":
                axis = int(self._static(ins[-1], "concat axis"))
                env[name] = torch.cat([t(i) for i in range(len(ins) - 1)],
                                      dim=axis)
                continue
            if op == "Transpose":
                env[name] = t(0).permute(*(int(p) for p in self._static(
                    ins[1], "permutation").ravel().tolist()))
                continue
            if op == "AddN":
                out = t(0)
                for i in range(1, len(ins)):
                    out = out + t(i)
                env[name] = out
                continue
            if op == "Shape":
                env[name] = torch.tensor(tuple(ins[0].shape),
                                         dtype=torch.int32,
                                         device=self.device)
                continue
            if op == "ArgMax":
                # int32, as JAX's with 64-bit types off
                env[name] = torch.argmax(
                    t(0), dim=int(self._static(ins[1], "axis"))).int()
                continue
            if op in ("FusedBatchNorm", "FusedBatchNormV2",
                      "FusedBatchNormV3"):
                if attrs.get("is_training", {}).get("b", False):
                    raise NotImplementedError(
                        f"{op} with is_training=true (node '{name}'): a "
                        "frozen inference graph normalizes with its "
                        "moving statistics")
                x, scale, offset, mean, var = (t(i) for i in range(5))
                eps = attrs.get("epsilon", {}).get("f", 1e-3)
                inv = torch.rsqrt(var + eps) * scale
                y = x * inv + (offset - mean * inv)
                # outputs 1..4 (batch stats) only exist in training
                # graphs; a frozen inference graph consumes output 0
                env[name] = (y, mean, var, mean, var)
                continue
            raise NotImplementedError(
                f"TF op '{op}' (node '{name}') is not supported "
                "by the frozen-graph importer; supported ops cover "
                "dense/conv/pool/batchnorm/elementwise/reduction/shape "
                "inference graphs")
        outs = [self._t(self._resolve(env, name))
                for name in self.output_names]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def predict(self, *feeds):
        if len(feeds) != len(self.input_names):
            raise ValueError(
                f"graph has {len(self.input_names)} placeholders "
                f"{self.input_names}, got {len(feeds)} inputs")
        with torch.inference_mode():
            out = self._eval(*feeds)
        if isinstance(out, tuple):
            return tuple(_to_numpy(o) for o in out)
        return _to_numpy(out)

    __call__ = predict


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:     # numpy has no bfloat16
        t = t.float()
    return t.cpu().numpy()


def _reduce(op: str, x, axes, keep: bool):
    if not axes:            # jnp reduces over no axis
        return x
    if op == "Mean":
        return x.mean(dim=axes, keepdim=keep)
    if op == "Sum":
        return x.sum(dim=axes, keepdim=keep)
    if op == "Max":
        return x.amax(dim=axes, keepdim=keep)
    if op == "Min":
        return x.amin(dim=axes, keepdim=keep)
    for d in sorted((a % x.dim() for a in axes), reverse=True):
        x = x.prod(dim=d, keepdim=keep)
    return x


def load_tf_graph(path_or_bytes, outputs: Optional[Sequence[str]] = None,
                  device=None) -> TFNet:
    """Load a frozen GraphDef `.pb` (file path or raw bytes) as a TFNet
    on `device` (None = the CUDA card, raising without one)."""
    return TFNet(parse_graphdef(read_bytes(path_or_bytes)),
                 outputs=outputs, device=device)
