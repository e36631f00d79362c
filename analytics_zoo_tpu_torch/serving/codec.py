"""ndarray wire encodings for serving (a copy of
analytics_zoo_tpu/serving/codec.py): base64-JSON (reference: the base64
ndarray encoding of `pyzoo/zoo/serving/client.py:157`
InputQueue.enqueue), base64 images, and Arrow IPC (reference:
`serving/serialization/ArrowDeserializer.scala`).  PIL and `pyarrow`
are imported when an image or an Arrow body is coded, not before.
`encode_record` / `decode_record` are the durable streams' record
payloads (JAX codec.py:65, :97): JSON whose ndarrays are the base64
encoding."""

from __future__ import annotations

import base64
from typing import Any, Dict, List, Sequence

import numpy as np

ARROW_CONTENT_TYPE = "application/vnd.apache.arrow.stream"


def encode_ndarray(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": str(a.dtype), "shape": list(a.shape)}


def decode_ndarray(enc: Any) -> np.ndarray:
    if isinstance(enc, dict) and "image_b64" in enc:
        return decode_image(enc)
    if isinstance(enc, dict) and "b64" in enc:
        a = np.frombuffer(base64.b64decode(enc["b64"]),
                          dtype=np.dtype(enc["dtype"]))
        return a.reshape(enc["shape"]).copy()
    # plain nested lists are accepted too
    return np.asarray(enc)


def encode_image(data, resize=None) -> Dict[str, Any]:
    """Wrap raw JPEG/PNG bytes (or a file path) as an image payload —
    the reference's base64-image enqueue (serving/client.py:157;
    decoded server-side by PreProcessing.decodeImage,
    serving/preprocessing/PreProcessing.scala:107)."""
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    enc: Dict[str, Any] = {
        "image_b64": base64.b64encode(data).decode("ascii")}
    if resize is not None:
        enc["resize"] = list(resize)
    return enc


def decode_image(enc: Dict[str, Any]) -> np.ndarray:
    """image payload -> float32 [1, H, W, C] pixel array (0-255).  An
    optional ``resize`` [H, W] resizes server-side, matching the
    reference's serving-side OpenCV resize."""
    from io import BytesIO

    from PIL import Image

    img = Image.open(BytesIO(base64.b64decode(enc["image_b64"])))
    img = img.convert("RGB")
    if enc.get("resize"):
        h, w = enc["resize"]
        img = img.resize((int(w), int(h)))
    return np.asarray(img, np.float32)[None]


def encode_arrow_tensors(arrays: Sequence[np.ndarray]) -> bytes:
    """Tensors -> one Arrow IPC stream: a RecordBatch with (dtype,
    shape, raw-bytes) per tensor.  ~25% smaller on the wire than
    base64-JSON and zero-copy decodable."""
    import pyarrow as pa

    arrays = [np.ascontiguousarray(a) for a in arrays]
    batch = pa.record_batch({
        "dtype": pa.array([str(a.dtype) for a in arrays]),
        "shape": pa.array([list(a.shape) for a in arrays],
                          type=pa.list_(pa.int64())),
        "data": pa.array([a.tobytes() for a in arrays],
                         type=pa.large_binary()),
    })
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return sink.getvalue().to_pybytes()


def decode_arrow_tensors(blob: bytes) -> List[np.ndarray]:
    import pyarrow as pa

    with pa.ipc.open_stream(pa.BufferReader(blob)) as r:
        table = r.read_all()
    out = []
    for dtype, shape, data in zip(table["dtype"].to_pylist(),
                                  table["shape"].to_pylist(),
                                  table["data"].to_pylist()):
        a = np.frombuffer(data, dtype=np.dtype(dtype))
        out.append(a.reshape(shape).copy())
    return out


def encode_record(doc: Dict[str, Any]) -> bytes:
    """One durable-stream record payload: a JSON document whose ndarray
    values (at any depth) become base64 ndarray encodings.  Inside a
    trace (an open span, or a context under `trace_context.bind`) a
    `"traceparent"` field is stamped on the top-level document, so the
    record carries its trace to whoever leases it; an existing field is
    kept."""
    import json

    def enc(v):
        if isinstance(v, np.ndarray):
            return encode_ndarray(v)
        if isinstance(v, dict):
            return {k: enc(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [enc(x) for x in v]
        if isinstance(v, (np.integer, np.floating)):
            return v.item()
        return v

    out = enc(doc)
    if isinstance(out, dict):
        from analytics_zoo_tpu_torch.observability import trace_context
        trace_context.inject_record(out)
    return json.dumps(out, separators=(",", ":")).encode()


def decode_record(blob: Any) -> Dict[str, Any]:
    """Inverse of `encode_record`; takes an already parsed document too
    (the HTTP dequeue path hands the handler parsed JSON)."""
    import json

    if isinstance(blob, (bytes, bytearray)):
        blob = json.loads(blob)

    def dec(v):
        if isinstance(v, dict):
            if "b64" in v and "dtype" in v or "image_b64" in v:
                return decode_ndarray(v)
            return {k: dec(x) for k, x in v.items()}
        if isinstance(v, list):
            return [dec(x) for x in v]
        return v

    return dec(blob)
