"""TFRecord image datasets (a port of
analytics_zoo_tpu/orca/data/image/tfrecord_dataset.py over the port's
XShards and wire-format helpers).

Reference: `pyzoo/zoo/orca/data/image/tfrecord_dataset.py` (ImageNet raw
TFRecords of tf.train.Examples).  Files written here use the real
tf.train.Example wire format (utils/tf_example.py) inside standard
TFRecord framing (utils/tfrecord.py), so they interoperate with
TensorFlow readers; reading streams one file per shard into XShards."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator

import numpy as np

from analytics_zoo_tpu_torch.orca.data.shard import XShards
from analytics_zoo_tpu_torch.utils.tf_example import (
    decode_example,
    encode_example,
)
from analytics_zoo_tpu_torch.utils.tfrecord import (
    TFRecordWriter,
    read_tfrecord_file,
)

_META = "_orca_tfrecord_schema.json"


class TFRecordDataset:
    @staticmethod
    def write(path: str, generator: Iterator[Dict[str, Any]],
              schema: Dict[str, str], records_per_file: int = 1000) -> str:
        """schema: {name: "bytes"|"int"|"float"|"ndarray"}.  ndarrays add
        `<name>/shape` + `<name>/dtype` features so reads reconstruct."""
        os.makedirs(path, exist_ok=True)

        def encode(rec: Dict[str, Any]) -> bytes:
            feats = {}
            for name, kind in schema.items():
                v = rec[name]
                if kind == "ndarray":
                    arr = np.ascontiguousarray(v)
                    feats[name] = arr.tobytes()
                    feats[f"{name}/shape"] = list(arr.shape)
                    feats[f"{name}/dtype"] = str(arr.dtype)
                else:
                    feats[name] = v
            return encode_example(feats)

        part, writer, count = 0, None, 0
        for rec in generator:
            if writer is None:
                writer = TFRecordWriter(
                    os.path.join(path, f"part-{part:05d}.tfrecord"))
            writer.write(encode(rec))
            count += 1
            if count >= records_per_file:
                writer.close()
                writer, count, part = None, 0, part + 1
        if writer is not None:
            writer.close()
        with open(os.path.join(path, _META), "w") as f:
            json.dump(schema, f)
        return path

    @staticmethod
    def read_as_xshards(path: str) -> XShards:
        """One shard per .tfrecord file; records decoded and stacked into
        the {col: array/list} block convention."""
        with open(os.path.join(path, _META)) as f:
            schema = json.load(f)
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".tfrecord"))

        def load(fp):
            rows = []
            for raw in read_tfrecord_file(fp):
                ex = decode_example(raw)
                rec = {}
                for name, kind in schema.items():
                    if kind == "ndarray":
                        dtype = ex[f"{name}/dtype"][0].decode()
                        shape = ex[f"{name}/shape"]
                        rec[name] = np.frombuffer(
                            ex[name][0], dtype=dtype).reshape(shape)
                    elif kind == "bytes":
                        rec[name] = ex[name][0]
                    elif kind == "int":
                        rec[name] = int(ex[name][0])
                    else:
                        rec[name] = float(ex[name][0])
                rows.append(rec)
            block: Dict[str, Any] = {}
            for name, kind in schema.items():
                vals = [r[name] for r in rows]
                if kind == "ndarray":
                    block[name] = np.stack(vals)
                elif kind in ("int", "float"):
                    block[name] = np.asarray(vals)
                else:
                    block[name] = vals
            return block

        # lazy per-file shards: nothing resident between epochs
        return XShards.from_sources(files, load)
