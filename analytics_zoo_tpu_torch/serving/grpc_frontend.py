"""gRPC serving front end (a port of analytics_zoo_tpu/serving/
grpc_frontend.py; reference: Cluster Serving's gRPC ingress,
`serving/grpc/FrontEndGRPCServiceImpl.scala` and `frontEndGRPC.proto`).

grpcio generic handlers with identity byte serializers and a small
hand-written wire codec (no generated code): the bytes are the JAX
package's, so either package's client talks to either server.  `grpc`
is imported only when a server or a client is built.  The front end
feeds the `ServingServer`'s batcher, so one process serves both
ingresses over one dynamic-batching model (or worker pool).

Wire messages:
    PredictRequest  { repeated Tensor inputs = 1; }
    Tensor          { repeated int32 shape = 1 [packed];
                      bytes f32_data = 2; }
    PredictResponse { repeated Tensor outputs = 1; string error = 2; }
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.utils.tf_example import (
    _len_delim,
    _read_varint,
    _varint,
    to_signed,
    walk_fields,
)


def _enc_tensor(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, "<f4")
    shape = b"".join(_varint(d) for d in arr.shape)
    return _len_delim(1, shape) + _len_delim(2, arr.tobytes())


def _dec_tensor(buf: bytes) -> np.ndarray:
    shape: List[int] = []
    data = b""
    for fnum, wire, v in walk_fields(buf):
        if fnum == 1:
            if wire == 2:
                pos = 0
                while pos < len(v):
                    d, pos = _read_varint(v, pos)
                    shape.append(to_signed(d))
            else:
                shape.append(to_signed(v))
        elif fnum == 2:
            data = v
    arr = np.frombuffer(data, "<f4")
    return arr.reshape(shape) if shape else arr


def encode_predict_request(inputs: Tuple[np.ndarray, ...]) -> bytes:
    return b"".join(_len_delim(1, _enc_tensor(a)) for a in inputs)


def decode_predict_request(buf: bytes) -> Tuple[np.ndarray, ...]:
    return tuple(_dec_tensor(v) for fnum, _, v in walk_fields(buf)
                 if fnum == 1)


def encode_predict_response(outputs, error: Optional[str] = None) -> bytes:
    if error:
        return _len_delim(2, error.encode())
    return b"".join(_len_delim(1, _enc_tensor(a)) for a in outputs)


def decode_predict_response(buf: bytes):
    outputs, error = [], None
    for fnum, _, v in walk_fields(buf):
        if fnum == 1:
            outputs.append(_dec_tensor(v))
        elif fnum == 2:
            error = v.decode()
    return outputs, error


class GrpcServingFrontend:
    """Wraps a `ServingServer` (its dynamic batcher + InferenceModel)
    with a gRPC `Predict` ingress."""

    def __init__(self, serving_server, host: str = "127.0.0.1",
                 port: int = 0):
        import grpc
        from concurrent import futures

        self._serving = serving_server
        ident = lambda b: b

        def predict(request: bytes, context) -> bytes:
            try:
                inputs = decode_predict_request(request)
                if not inputs:
                    raise ValueError("no input tensors")
                out, err = self._serving._submit(inputs)
                if err:
                    return encode_predict_response(None, err)
                return encode_predict_response(out)
            except Exception as e:
                return encode_predict_response(
                    None, f"{type(e).__name__}: {e}")

        handler = grpc.method_handlers_generic_handler(
            "ServingFrontend",
            {"Predict": grpc.unary_unary_rpc_method_handler(
                predict, request_deserializer=ident,
                response_serializer=ident)})
        self._server = grpc.server(futures.ThreadPoolExecutor(8))
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host

    def start(self) -> "GrpcServingFrontend":
        self._server.start()
        return self

    def stop(self, grace: float = 0.5):
        self._server.stop(grace)


class GrpcInputQueue:
    """gRPC counterpart of the HTTP `InputQueue` client."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import grpc
        self._chan = grpc.insecure_channel(f"{host}:{port}")
        self._fn = self._chan.unary_unary(
            "/ServingFrontend/Predict",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)

    def predict(self, *inputs: np.ndarray, batched: bool = False):
        """Like the HTTP InputQueue: a single RECORD by default (gets a
        batch dim added and joins the dynamic batch; the dim is stripped
        from the result); pass batched=True for pre-batched arrays."""
        arrays = tuple(np.asarray(a, np.float32) for a in inputs)
        if not batched:
            arrays = tuple(a[None] for a in arrays)
        reply = self._fn(encode_predict_request(arrays))
        outputs, error = decode_predict_response(reply)
        if error:
            raise RuntimeError(f"serving error: {error}")
        if not batched:
            outputs = [o[0] for o in outputs]
        return outputs[0] if len(outputs) == 1 else tuple(outputs)

    def close(self):
        self._chan.close()
