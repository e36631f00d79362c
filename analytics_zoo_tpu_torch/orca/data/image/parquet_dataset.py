"""Parquet image datasets (a port of
analytics_zoo_tpu/orca/data/image/parquet_dataset.py over the port's
XShards).  Host only: pandas (and pyarrow under it) is imported by the
functions that write or read a part-file, when they run.

Reference: `pyzoo/zoo/orca/data/image/parquet_dataset.py` —
`ParquetDataset.write(path, generator, schema)`, `write_from_directory`
(class-folder images), `write_mnist` (idx files), `write_voc`
(VOCdevkit), and readers back into the training data plane.

pyarrow writes row-group-sized blocks directly (no
Spark job); ndarray-valued columns are stored as raw bytes alongside
`<name>/shape` + `<name>/dtype` columns; `read_as_xshards` streams one
parquet part-file per shard, so the dataset feeds `Estimator.fit` through
the streaming HostDataset path without materializing."""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.orca.data.shard import XShards

_META = "_orca_schema.json"


class SchemaField:
    """Column spec: feature_type "ndarray" | "image" (bytes) | "scalar"."""

    def __init__(self, feature_type: str, dtype: str = "float32",
                 shape: Optional[Sequence[int]] = None):
        self.feature_type = feature_type
        self.dtype = dtype
        self.shape = list(shape) if shape else None

    def to_dict(self):
        return {"feature_type": self.feature_type, "dtype": self.dtype,
                "shape": self.shape}


def _normalize_schema(schema: Dict[str, Any]) -> Dict[str, Dict]:
    out = {}
    for k, v in schema.items():
        if isinstance(v, SchemaField):
            out[k] = v.to_dict()
        elif isinstance(v, dict):
            out[k] = {"feature_type": v.get("feature_type", "scalar"),
                      "dtype": v.get("dtype", "float32"),
                      "shape": v.get("shape")}
        else:
            out[k] = {"feature_type": str(v), "dtype": "float32",
                      "shape": None}
    return out


class ParquetDataset:
    @staticmethod
    def write(path: str, generator: Iterator[Dict[str, Any]],
              schema: Dict[str, Any], block_size: int = 1000,
              write_mode: str = "overwrite") -> str:
        """Drain `generator` (dicts of column values) into parquet
        part-files of `block_size` records each (reference
        parquet_dataset.py:38)."""
        import pandas as pd

        if write_mode not in ("overwrite", "errorifexists"):
            raise ValueError(
                f"unsupported write_mode {write_mode!r}; use 'overwrite' "
                "or 'errorifexists' (partial part-file overwrites would "
                "corrupt an existing dataset)")
        schema = _normalize_schema(schema)
        if os.path.exists(path):
            if write_mode == "errorifexists":
                raise FileExistsError(path)
            import shutil
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)

        def flush(rows: List[Dict], part: int):
            cols: Dict[str, List] = {}
            for name, spec in schema.items():
                vals = [r[name] for r in rows]
                if spec["feature_type"] == "ndarray":
                    cols[name] = [np.ascontiguousarray(v).tobytes()
                                  for v in vals]
                    cols[f"{name}/shape"] = [
                        json.dumps(list(np.shape(v))) for v in vals]
                    cols[f"{name}/dtype"] = [
                        str(np.asarray(v).dtype) for v in vals]
                else:
                    cols[name] = vals
            pd.DataFrame(cols).to_parquet(
                os.path.join(path, f"part-{part:05d}.parquet"))

        rows, part = [], 0
        for rec in generator:
            rows.append(rec)
            if len(rows) >= block_size:
                flush(rows, part)
                rows, part = [], part + 1
        if rows:
            flush(rows, part)
        with open(os.path.join(path, _META), "w") as f:
            json.dump(schema, f)
        return path

    @staticmethod
    def read_as_xshards(path: str) -> XShards:
        return read_parquet_as_xshards(path)


def _decode_block(df, schema: Dict[str, Dict]) -> Dict[str, np.ndarray]:
    """One parquet part -> {"col": stacked ndarray} training block."""
    out = {}
    for name, spec in schema.items():
        if spec["feature_type"] == "ndarray":
            arrs = []
            for raw, shp, dt in zip(df[name], df[f"{name}/shape"],
                                    df[f"{name}/dtype"]):
                arrs.append(np.frombuffer(raw, dtype=dt)
                            .reshape(json.loads(shp)))
            shapes = {a.shape for a in arrs}
            # ragged rows (e.g. per-image box counts) stay a list
            out[name] = np.stack(arrs) if len(shapes) == 1 else arrs
        elif spec["feature_type"] == "image":
            out[name] = list(df[name])  # raw encoded bytes
        else:
            out[name] = df[name].to_numpy()
    return out


def read_parquet_as_xshards(path: str,
                            columns: Optional[Sequence[str]] = None
                            ) -> XShards:
    """One shard per part-file, decoded lazily under the DISK tier
    (reference parquet_dataset.py:96 `_read_as_xshards`)."""
    import pandas as pd

    with open(os.path.join(path, _META)) as f:
        schema = json.load(f)
    if columns:
        schema = {k: v for k, v in schema.items() if k in columns}
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.endswith(".parquet"))
    # push the projection into the parquet read: deselected columns
    # (e.g. multi-MB image bytes) are never pulled off disk
    read_cols = []
    for name, spec in schema.items():
        read_cols.append(name)
        if spec["feature_type"] == "ndarray":
            read_cols += [f"{name}/shape", f"{name}/dtype"]

    def load(fp):
        return _decode_block(pd.read_parquet(fp, columns=read_cols),
                             schema)

    # lazy: each epoch re-reads part-files; nothing resident in-process
    return XShards.from_sources(files, load)


# ---------------------------------------------------------------------------
# format-specific writers (reference parquet_dataset.py:237-338)
# ---------------------------------------------------------------------------

def write_from_directory(directory: str, label_map: Optional[Dict] = None,
                         output_path: str = None, shuffle: bool = True,
                         seed: int = 0, **kwargs) -> str:
    """Class-folder image tree -> parquet of {image(bytes), label, uri}
    (reference :237)."""
    from analytics_zoo_tpu_torch.feature.image.imageset import _IMG_EXTS

    classes = sorted(d for d in os.listdir(directory)
                     if os.path.isdir(os.path.join(directory, d)))
    label_map = label_map or {c: i for i, c in enumerate(classes)}
    items = []
    for c in classes:
        for f in sorted(os.listdir(os.path.join(directory, c))):
            if f.lower().endswith(_IMG_EXTS):  # skip READMEs, .DS_Store...
                items.append((os.path.join(directory, c, f), label_map[c]))
    if shuffle:
        np.random.default_rng(seed).shuffle(items)

    def gen():
        for fp, label in items:
            with open(fp, "rb") as f:
                yield {"image": f.read(), "label": label, "uri": fp}

    schema = {"image": SchemaField("image"),
              "label": SchemaField("scalar", "int64"),
              "uri": SchemaField("scalar", "str")}
    return ParquetDataset.write(output_path, gen(), schema, **kwargs)


def _read_idx(path: str) -> np.ndarray:
    """Parse an MNIST idx file (images or labels)."""
    with open(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def write_mnist(image_file: str, label_file: str, output_path: str,
                **kwargs) -> str:
    """MNIST idx files -> parquet of {image: [28,28] ndarray, label}
    (reference :288)."""
    images = _read_idx(image_file)
    labels = _read_idx(label_file)

    def gen():
        for img, y in zip(images, labels):
            yield {"image": img, "label": int(y)}

    schema = {"image": SchemaField("ndarray", "uint8"),
              "label": SchemaField("scalar", "int64")}
    return ParquetDataset.write(output_path, gen(), schema, **kwargs)


def write_voc(voc_root_path: str, splits_names: Sequence,
              output_path: str, **kwargs) -> str:
    """VOCdevkit -> parquet of {image(bytes), boxes [n,4] xyxy float32,
    labels [n] int64, uri} (reference :294).  `splits_names` is
    [(year_dir, split), ...] like the reference, e.g.
    [("VOC2007", "trainval")]."""
    import xml.etree.ElementTree as ET

    records = []
    for year_dir, split in splits_names:
        base = os.path.join(voc_root_path, str(year_dir))
        with open(os.path.join(base, "ImageSets", "Main",
                               f"{split}.txt")) as f:
            ids = [line.split()[0] for line in f if line.strip()]
        for image_id in ids:
            ann = ET.parse(
                os.path.join(base, "Annotations", f"{image_id}.xml"))
            boxes, names = [], []
            for obj in ann.findall("object"):
                bb = obj.find("bndbox")
                boxes.append([float(bb.find(k).text) for k in
                              ("xmin", "ymin", "xmax", "ymax")])
                names.append(obj.find("name").text.strip())
            records.append(
                (os.path.join(base, "JPEGImages", f"{image_id}.jpg"),
                 np.asarray(boxes, np.float32).reshape(-1, 4), names))

    classes = sorted({n for _, _, names in records for n in names})
    class_map = {c: i for i, c in enumerate(classes)}

    def gen():
        for fp, boxes, names in records:
            with open(fp, "rb") as f:
                yield {"image": f.read(), "boxes": boxes,
                       "labels": np.asarray(
                           [class_map[n] for n in names], np.int64),
                       "uri": fp}

    schema = {"image": SchemaField("image"),
              "boxes": SchemaField("ndarray", "float32"),
              "labels": SchemaField("ndarray", "int64"),
              "uri": SchemaField("scalar", "str")}
    out = ParquetDataset.write(output_path, gen(), schema, **kwargs)
    with open(os.path.join(out, "_voc_classes.json"), "w") as f:
        json.dump(classes, f)
    return out


def write_parquet(format: str, output_path: str, *args, **kwargs) -> str:
    """Dispatcher matching the reference's `write_parquet(format=...)`
    (reference :326)."""
    writers: Dict[str, Callable] = {
        "mnist": write_mnist,
        "voc": write_voc,
        "image_folder": write_from_directory,
    }
    if format not in writers:
        raise ValueError(
            f"unknown format {format!r}; expected {sorted(writers)}")
    if format == "image_folder":
        return write_from_directory(*args, output_path=output_path,
                                    **kwargs)
    return writers[format](*args, output_path, **kwargs)
