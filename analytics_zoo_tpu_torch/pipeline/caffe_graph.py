"""Caffe `.caffemodel` importer on torch (counterpart of
analytics_zoo_tpu/pipeline/caffe_graph.py; reference
`models/caffe/{CaffeLoader,Converter,LayerConverter}.scala` and
`Net.load_caffe`).

The binary NetParameter protobuf is decoded with the repo's wire-format
reader (no caffe, no protoc) and the layers run as torch ops in NCHW,
Caffe's own layout and torch's, on the device the net was built for:
no transposes at the boundary, and InnerProduct's flatten is Caffe's
CHW order as it stands.  A blob's packed floats are decoded with
`np.frombuffer` over a view of the file (no Python list: BVLC
CaffeNet's 61M weights would need about 2 GB as one), bitwise the
values JAX's list-building decoder gives; each layer's weights are
copied to the device once, when the net is built.

Caffe's pooling arithmetic is reproduced exactly: the output is
ceil((X + 2p - k) / s) + 1, less one where the last window would start
in the far padding; MAX pools the windows padded with -inf, AVE divides
by the window clipped to [0, X + p) (the zero padding counts, the
ceil-mode extension does not).  Neither `ceil_mode` nor
`count_include_pad` of `F.avg_pool2d` is that rule, so both are built
from explicit padding and a pooled mask.

Scope: modern `layer` (LayerParameter) caffemodels.  Pre-2015
V1LayerParameter nets and `Deconvolution` raise with JAX's messages.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.pipeline.onnx.onnx_loader import (
    channel_window_sum,
    padded_max,
    read_bytes,
    window_sum,
)
from analytics_zoo_tpu_torch.utils.tf_example import (
    packed_floats as _packed_floats,
    packed_ints as _packed_ints,
    to_signed,
    to_str as _str,
    walk_fields,
)


def _parse_blob(buf) -> np.ndarray:
    shape: List[int] = []
    chunks: List[np.ndarray] = []
    legacy = {}
    for fnum, wt, val in walk_fields(buf):
        if fnum == 7:     # BlobShape
            for f2, wt2, v2 in walk_fields(val):
                if f2 == 1:
                    shape.extend(_packed_ints(v2, wt2))
        elif fnum == 5:   # data (packed float, or one fixed32 per tag)
            chunks.append(np.frombuffer(val, "<f4") if wt == 2
                          else np.asarray(_packed_floats(val, wt),
                                          np.float32))
        elif fnum == 8:   # double_data (packed, or one fixed64 per tag)
            if wt in (1, 2):
                chunks.append(np.frombuffer(val, "<f8").astype(np.float32))
            else:
                raise ValueError(
                    f"double_data with unexpected wire type {wt}; "
                    "dropping it would silently truncate the blob")
        # 6 (diff) and 9 (double_diff) are solver gradient state —
        # deliberately ignored, never mistaken for weights
        elif fnum in (1, 2, 3, 4):  # legacy num/channels/height/width
            legacy[fnum] = val
    if not shape and legacy:
        shape = [legacy.get(k, 1) for k in (1, 2, 3, 4)]
    if len(chunks) == 1:
        arr = chunks[0].astype(np.float32, copy=False)
    else:
        arr = (np.concatenate(chunks).astype(np.float32, copy=False)
               if chunks else np.zeros(0, np.float32))
    return arr.reshape(shape) if shape else arr


def _parse_params(buf, spec: Dict[int, str]) -> Dict[str, Any]:
    """Decode a *Parameter submessage given {field: name} with repeated
    numeric fields accumulated into lists."""
    out: Dict[str, Any] = {}
    for fnum, wt, val in walk_fields(buf):
        name = spec.get(fnum)
        if name is None:
            continue
        if name.endswith("_f"):        # float scalar
            out[name] = float(np.frombuffer(val, "<f4")[0])
        elif name.endswith("_lf"):     # repeated float
            out.setdefault(name, []).extend(_packed_floats(val, wt))
        elif name.endswith("_l"):      # repeated int
            out.setdefault(name, []).extend(_packed_ints(val, wt))
        else:                          # int/bool/enum scalar
            out[name] = to_signed(val) if isinstance(val, int) \
                else bytes(val)
    return out


_CONV_SPEC = {1: "num_output", 2: "bias_term", 3: "pad_l",
              4: "kernel_l", 5: "group", 6: "stride_l",
              9: "pad_h", 10: "pad_w", 11: "kernel_h", 12: "kernel_w",
              13: "stride_h", 14: "stride_w", 18: "dilation_l"}
_POOL_SPEC = {1: "pool", 2: "kernel_size", 3: "stride", 4: "pad",
              5: "kernel_h", 6: "kernel_w", 7: "stride_h",
              8: "stride_w", 9: "pad_h", 10: "pad_w",
              12: "global_pooling"}
_IP_SPEC = {1: "num_output", 2: "bias_term", 5: "axis", 6: "transpose"}
_LRN_SPEC = {1: "local_size", 2: "alpha_f", 3: "beta_f",
             4: "norm_region", 5: "k_f"}
_BN_SPEC = {1: "use_global_stats", 2: "maf_f", 3: "eps_f"}
_SCALE_SPEC = {1: "axis", 2: "num_axes", 4: "bias_term"}
_ELTWISE_SPEC = {1: "operation", 2: "coeff_lf"}
_CONCAT_SPEC = {1: "concat_dim", 2: "axis"}
_POWER_SPEC = {1: "power_f", 2: "scale_f", 3: "shift_f"}

_PARAM_FIELDS = {104: ("concat", _CONCAT_SPEC),
                 106: ("conv", _CONV_SPEC),
                 110: ("eltwise", _ELTWISE_SPEC),
                 117: ("ip", _IP_SPEC),
                 118: ("lrn", _LRN_SPEC),
                 121: ("pool", _POOL_SPEC),
                 122: ("power", _POWER_SPEC),
                 139: ("bn", _BN_SPEC),
                 142: ("scale", _SCALE_SPEC)}


def _parse_layer(buf) -> Dict[str, Any]:
    layer = {"name": "", "type": "", "bottoms": [], "tops": [],
             "blobs": [], "params": {}, "phase": None}
    for fnum, wt, val in walk_fields(buf):
        if fnum == 1:
            layer["name"] = _str(val)
        elif fnum == 2:
            layer["type"] = _str(val)
        elif fnum == 3:
            layer["bottoms"].append(_str(val))
        elif fnum == 4:
            layer["tops"].append(_str(val))
        elif fnum == 7:
            layer["blobs"].append(_parse_blob(val))
        elif fnum == 8:   # include: NetStateRule { phase = 1 }
            for f2, _, v2 in walk_fields(val):
                if f2 == 1:
                    layer["phase"] = v2    # 0 TRAIN, 1 TEST
        elif fnum in _PARAM_FIELDS:
            key, spec = _PARAM_FIELDS[fnum]
            layer["params"][key] = _parse_params(val, spec)
    return layer


def parse_caffemodel(data) -> Dict[str, Any]:
    """NetParameter bytes -> {name, inputs, input_shapes, layers}; a
    blob's packed floats are a numpy view of `data`."""
    net = {"name": "", "inputs": [], "input_shapes": [], "layers": []}
    saw_v1 = False
    for fnum, wt, val in walk_fields(memoryview(data)):
        if fnum == 1:
            net["name"] = _str(val)
        elif fnum == 2:
            saw_v1 = True
        elif fnum == 3:
            net["inputs"].append(_str(val))
        elif fnum == 8:   # input_shape: BlobShape
            dims = []
            for f2, wt2, v2 in walk_fields(val):
                if f2 == 1:
                    dims.extend(_packed_ints(v2, wt2))
            net["input_shapes"].append(dims)
        elif fnum == 100:
            net["layers"].append(_parse_layer(val))
    if saw_v1 and not net["layers"]:
        raise NotImplementedError(
            "V1LayerParameter caffemodel (pre-2015): upgrade it with "
            "caffe's upgrade_net_proto_binary, or convert to ONNX and "
            "use Net.load_onnx")
    return net


# ---------------------------------------------------------------------
# execution (NCHW)
# ---------------------------------------------------------------------


def _conv_geometry(p, key_h, key_w, key_l, default):
    h = p.get(key_h)
    w = p.get(key_w)
    if h is not None or w is not None:
        return int(h or default), int(w or default)
    lst = p.get(key_l) or []
    if len(lst) == 0:
        return default, default
    if len(lst) == 1:
        return int(lst[0]), int(lst[0])
    return int(lst[0]), int(lst[1])


def _ceil_pool_geometry(h, w, kh, kw, sh, sw, ph, pw):
    """Caffe pooling output = ceil((X + 2p - k)/s) + 1 (with the
    far-side clip); returns (oh, ow, pad_pairs) such that VALID
    pooling over the padded input, sliced to [:oh, :ow], reproduces
    exactly Caffe's windows."""
    oh = int(math.ceil((h + 2 * ph - kh) / sh)) + 1
    ow = int(math.ceil((w + 2 * pw - kw) / sw)) + 1
    # caffe clips windows that start inside the padding on the far side
    if ph > 0 and (oh - 1) * sh >= h + ph:
        oh -= 1
    if pw > 0 and (ow - 1) * sw >= w + pw:
        ow -= 1
    eh = (oh - 1) * sh + kh - (h + ph)   # extra beyond the symmetric pad
    ew = (ow - 1) * sw + kw - (w + pw)
    return oh, ow, ((ph, max(eh, 0)), (pw, max(ew, 0)))


def _channels(v, x):
    """A per-channel vector shaped to broadcast over x's channel axis
    (1 in NCHW, the last axis of a 2-D [n, c])."""
    v = v.reshape(-1)
    return v.reshape((1, -1) + (1,) * (x.dim() - 2)) if x.dim() > 2 else v


def _device_blobs(ly) -> List[np.ndarray]:
    """The host arrays a layer reads on the device: its blobs, or for a
    BatchNorm its mean and variance divided by the scale factor."""
    if ly["type"] != "BatchNorm":
        return ly["blobs"]
    mean, var, sf = (b.reshape(-1) for b in ly["blobs"][:3])
    scale = 1.0 / sf[0] if sf.size and sf[0] != 0 else 1.0
    return [mean * scale, var * scale]


class CaffeNet:
    """A Caffe net as a function of NCHW torch tensors on `device` (None
    = the CUDA card).  `predict(*arrays)` takes Caffe-layout inputs and
    returns numpy NCHW / 2-D outputs; `_eval(*tensors)` returns
    tensors."""

    def __init__(self, net: Dict[str, Any],
                 outputs: Optional[Sequence[str]] = None, device=None):
        self.device = resolve_device(device)
        self.net = net
        # runnable layers: skip TRAIN-only and data/loss bookkeeping
        self.layers = [
            ly for ly in net["layers"]
            if ly["phase"] != 0 and ly["type"] not in (
                "Data", "ImageData", "HDF5Data", "Accuracy", "Silence")]
        self.input_names = list(net["inputs"]) + [
            ly["tops"][0] for ly in self.layers if ly["type"] == "Input"]
        consumed = {b for ly in self.layers for b in ly["bottoms"]}
        if outputs is None:
            # layer order, not set order: multi-output nets must give a
            # deterministic output tuple across processes
            outputs = [t for ly in self.layers for t in ly["tops"]
                       if t not in consumed and t not in self.input_names]
            if not outputs and self.layers:
                # every top is also consumed — happens when the net
                # ends in an IN-PLACE layer (top == bottom, e.g. a
                # trailing ReLU); the last layer's top is the output
                outputs = [self.layers[-1]["tops"][0]]
        self.output_names = list(outputs)
        #: each layer's blobs on the device, copied once
        self.weights: Dict[str, List[torch.Tensor]] = {
            ly["name"]: [torch.tensor(b, device=self.device)
                         for b in _device_blobs(ly)]
            for ly in self.layers}

    # -- per-layer semantics ------------------------------------------

    def _eval(self, *feeds):
        env: Dict[str, Any] = {
            name: x if isinstance(x, torch.Tensor) and x.device == self.device
            else torch.as_tensor(np.asarray(x) if not isinstance(
                x, torch.Tensor) else x, device=self.device)
            for name, x in zip(self.input_names, feeds)}

        for ly in self.layers:
            typ, p = ly["type"], ly["params"]
            blobs = self.weights[ly["name"]]
            ins = [env[b] for b in ly["bottoms"]]
            x = ins[0] if ins else None
            if typ == "Input":
                continue
            elif typ == "Deconvolution":
                # caffe deconv blobs are [C_in, C_out/g, kh, kw] with
                # transposed-conv geometry — misdeclaring either gives
                # silently wrong outputs, so refuse rather than guess
                raise NotImplementedError(
                    "Caffe Deconvolution import is not supported; "
                    "convert the model to ONNX (ConvTranspose) and use "
                    "Net.load_onnx")
            elif typ == "Convolution":
                cp = p.get("conv", {})
                kh, kw = _conv_geometry(cp, "kernel_h", "kernel_w",
                                        "kernel_l", 3)
                sh, sw = _conv_geometry(cp, "stride_h", "stride_w",
                                        "stride_l", 1)
                ph, pw = _conv_geometry(cp, "pad_h", "pad_w", "pad_l", 0)
                dh, dw = _conv_geometry(cp, None, None, "dilation_l", 1)
                groups = int(cp.get("group", 1))
                n_out = int(cp["num_output"])
                cin = x.shape[1] // groups
                w = blobs[0].reshape(n_out, cin, kh, kw)     # OIHW
                bias = (blobs[1].reshape(-1)
                        if int(cp.get("bias_term", 1)) and len(blobs) > 1
                        else None)
                out = F.conv2d(x, w, bias, (sh, sw), (ph, pw), (dh, dw),
                               groups)
            elif typ in ("InnerProduct",):
                ip = p.get("ip", {})
                x2 = x.reshape(x.shape[0], -1)   # CHW order in NCHW
                w2 = blobs[0].reshape(blobs[0].shape[0], -1)
                out = x2 @ (w2 if int(ip.get("transpose", 0)) else w2.T)
                if int(ip.get("bias_term", 1)) and len(blobs) > 1:
                    out = out + blobs[1].reshape(-1)
            elif typ == "Pooling":
                pp = p.get("pool", {})
                if int(pp.get("global_pooling", 0)):
                    out = (x.amax(dim=(2, 3), keepdim=True)
                           if int(pp.get("pool", 0)) == 0
                           else x.mean(dim=(2, 3), keepdim=True))
                else:
                    out = self._pool(x, pp)
            elif typ == "ReLU":
                out = F.relu(x)
            elif typ == "PReLU":
                out = torch.where(x >= 0, x, _channels(blobs[0], x) * x)
            elif typ == "ELU":
                out = F.elu(x)
            elif typ == "Sigmoid":
                out = torch.sigmoid(x)
            elif typ == "TanH":
                out = torch.tanh(x)
            elif typ == "AbsVal":
                out = torch.abs(x)
            elif typ == "Log":
                out = torch.log(x)
            elif typ == "Exp":
                out = torch.exp(x)
            elif typ == "Power":
                pw_ = p.get("power", {})
                out = (pw_.get("shift_f", 0.0)
                       + pw_.get("scale_f", 1.0) * x) \
                    ** pw_.get("power_f", 1.0)
            elif typ in ("Softmax", "SoftmaxWithLoss"):
                # caffe softmaxes over channels: axis 1 of NCHW, the last
                # axis otherwise (JAX's NHWC last axis)
                out = torch.softmax(x, dim=1 if x.dim() == 4 else -1)
            elif typ == "Dropout":
                out = x                     # inference = identity
            elif typ == "LRN":
                out = self._lrn(x, p.get("lrn", {}))
            elif typ == "BatchNorm":
                eps = p.get("bn", {}).get("eps_f", 1e-5)
                mean, var = blobs
                out = (x - _channels(mean, x)) * torch.rsqrt(
                    _channels(var, x) + eps)
            elif typ == "Scale":
                if len(ins) == 2:
                    # two-bottom form: the scaler is a tensor input
                    other = ins[1]
                    if other.dim() == 1:     # per-channel
                        out = x * _channels(other, x)
                    elif other.shape == x.shape:
                        out = x * other
                    else:
                        raise NotImplementedError(
                            f"Scale layer '{ly['name']}': two-bottom "
                            f"broadcast {tuple(other.shape)} vs "
                            f"{tuple(x.shape)} not supported")
                elif blobs:
                    out = x * _channels(blobs[0], x)
                    if int(p.get("scale", {}).get("bias_term", 0)) \
                            and len(blobs) > 1:
                        out = out + _channels(blobs[1], x)
                else:
                    raise NotImplementedError(
                        f"Scale layer '{ly['name']}' has neither blobs "
                        "nor a second bottom")
            elif typ == "Eltwise":
                ep = p.get("eltwise", {})
                operation = int(ep.get("operation", 1))
                if operation == 0:      # PROD
                    out = ins[0]
                    for y in ins[1:]:
                        out = out * y
                elif operation == 2:    # MAX
                    out = ins[0]
                    for y in ins[1:]:
                        out = torch.maximum(out, y)
                else:                   # SUM (with optional coeffs)
                    coeff = ep.get("coeff_lf") or [1.0] * len(ins)
                    out = coeff[0] * ins[0]
                    for c, y in zip(coeff[1:], ins[1:]):
                        out = out + c * y
            elif typ == "Concat":
                cp = p.get("concat", {})
                axis = int(cp.get("axis", cp.get("concat_dim", 1)))
                out = torch.cat(ins, dim=axis % ins[0].dim())
            elif typ == "Flatten":
                out = x.reshape(x.shape[0], -1)
            else:
                raise NotImplementedError(
                    f"Caffe layer type '{typ}' (layer '{ly['name']}') "
                    "is not supported by the importer")
            env[ly["tops"][0]] = out

        outs = [env[name] for name in self.output_names]
        return outs[0] if len(outs) == 1 else tuple(outs)

    @staticmethod
    def _pool(x, pp):
        kh, kw = _conv_geometry(pp, "kernel_h", "kernel_w", None,
                                int(pp.get("kernel_size", 2)))
        sh, sw = _conv_geometry(pp, "stride_h", "stride_w", None,
                                int(pp.get("stride", 1)))
        ph, pw = _conv_geometry(pp, "pad_h", "pad_w", None,
                                int(pp.get("pad", 0)))
        h_in, w_in = x.shape[2], x.shape[3]
        oh, ow, ((pt, pb), (pl, pr)) = _ceil_pool_geometry(
            h_in, w_in, kh, kw, sh, sw, ph, pw)
        flat = [pl, pr, pt, pb]
        if int(pp.get("pool", 0)) == 0:   # MAX
            return padded_max(x, flat, (kh, kw), (sh, sw))[:, :, :oh, :ow]
        # AVE: caffe's divisor is the window clipped to [0, X + pad):
        # zero padding counts, the ceil-mode far extension does not
        xp = F.pad(x, flat) if any(flat) else x
        s = window_sum(xp, (kh, kw), (sh, sw))[:, :, :oh, :ow]
        mask = torch.zeros((1, 1) + tuple(xp.shape[2:]), dtype=x.dtype,
                           device=x.device)
        mask[:, :, :h_in + 2 * pt, :w_in + 2 * pl] = 1.0
        cnt = window_sum(mask, (kh, kw), (sh, sw))[:, :, :oh, :ow]
        return s / torch.clamp(cnt, min=1.0)

    @staticmethod
    def _lrn(x, lp):
        n = int(lp.get("local_size", 5))
        alpha = lp.get("alpha_f", 1.0)
        beta = lp.get("beta_f", 0.75)
        k = lp.get("k_f", 1.0)
        sq = x * x
        # lax's SAME window: (n - 1) // 2 before, the rest after
        lo, hi = (n - 1) // 2, n - 1 - (n - 1) // 2
        if int(lp.get("norm_region", 0)) == 0:  # ACROSS_CHANNELS
            s = channel_window_sum(sq, lo, hi)
            div = n
        else:                                   # WITHIN_CHANNEL
            s = window_sum(F.pad(sq, [lo, hi, lo, hi]), (n, n), (1, 1))
            div = n * n
        return x / torch.pow(k + alpha / div * s, beta)

    def predict(self, *feeds):
        if len(feeds) != len(self.input_names):
            raise ValueError(
                f"net has {len(self.input_names)} inputs "
                f"{self.input_names}, got {len(feeds)}")
        with torch.inference_mode():
            out = self._eval(*feeds)
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    __call__ = predict


def load_caffe(def_path: Optional[str], model_path_or_bytes,
               outputs: Optional[Sequence[str]] = None,
               device=None) -> CaffeNet:
    """Load a Caffe model (reference Net.load_caffe(defPath,
    modelPath)) on `device` (None = the CUDA card).  The binary
    caffemodel carries both topology and weights; `def_path` (deploy
    prototxt) is consulted only for the `input:` declaration when the
    binary lacks one."""
    net = parse_caffemodel(read_bytes(model_path_or_bytes))
    if not net["inputs"] and def_path:
        with open(def_path) as f:
            txt = f.read()
        net["inputs"] = re.findall(r'^\s*input\s*:\s*"([^"]+)"', txt,
                                   re.M)
    return CaffeNet(net, outputs=outputs, device=device)
