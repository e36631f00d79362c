"""The port's feature pipeline (analytics_zoo_tpu_torch/feature/) and image
readers (orca/data/image/) against the JAX package's on the CPU:

* every `Image*` transform, on records with a "uri" (a generator per
  record) and on bare arrays (the lock-protected stream), gives the
  JAX transform's arrays exactly, and so does a seeded chain through
  `ImageSet.from_arrays(...).transform(...).to_dataset()`; the resizing
  ones need cv2 (skipped without it);
* the record-level Preprocessing vocabulary, over records and XShards;
  a TextSet raises (text_set.py is not ported);
* `ImageSet.read` of a temp directory of PNGs (flat and class folders)
  equals JAX's, and `to_dataset` feeds a port `fit`;
* TFRecord and parquet datasets round trip, and each package reads the
  other's files; the Example codec writes JAX's bytes.
"""

import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature import common as jcommon
from analytics_zoo_tpu.feature.image import transforms as jtf
from analytics_zoo_tpu.feature.image.imageset import ImageSet as JaxImageSet
from analytics_zoo_tpu.orca.data.image import (
    TFRecordDataset as JaxTFRecordDataset,
    read_parquet_as_xshards as jax_read_parquet,
)
from analytics_zoo_tpu.utils import tf_example as jex
from analytics_zoo_tpu_torch.feature import common
from analytics_zoo_tpu_torch.feature.image import ImageSet
from analytics_zoo_tpu_torch.feature.image import transforms as tf
from analytics_zoo_tpu_torch.orca.data import XShards
from analytics_zoo_tpu_torch.orca.data.image import (
    ParquetDataset,
    TFRecordDataset,
    read_parquet_as_xshards,
    write_from_directory,
)
from analytics_zoo_tpu_torch.utils import tf_example as ex

#: (name, constructor arguments); the random ones take a seed
TRANSFORMS = [
    ("ImageBrightness", (-30.0, 30.0), {"seed": 3}),
    ("ImageChannelNormalize", (120.0, 110.0, 100.0, 60.0, 50.0, 40.0), {}),
    ("ImagePixelNormalize", (np.full((20, 24, 3), 7.0),), {}),
    ("ImageCenterCrop", (16, 12), {}),
    ("ImageRandomCrop", (16, 12), {"seed": 4}),
    ("ImageHFlip", (), {"p": 0.5, "seed": 5}),
    ("ImageHFlip", (), {}),
    ("ImageExpand", (), {"max_expand_ratio": 2.0, "seed": 6}),
    ("ImageMatToTensor", (), {}),
    ("ImageMatToTensor", (), {"format": "NCHW"}),
    ("ImageResize", (10, 14), {}),
    ("ImageAspectScale", (10,), {"max_size": 30, "scale_multiple_of": 4}),
]


def _images(n=6, h=20, w=24, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("name,args,kw", TRANSFORMS,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(TRANSFORMS)])
def test_transform_matches_jax(name, args, kw):
    if name in ("ImageResize", "ImageAspectScale"):
        pytest.importorskip("cv2")
    got_t, want_t = getattr(tf, name)(*args, **kw), \
        getattr(jtf, name)(*args, **kw)
    for i, img in enumerate(_images()):
        rec = {"image": img, "uri": f"img{i}.png", "label": i}
        got, want = got_t.apply(rec), want_t.apply(rec)
        assert got.keys() == want.keys()
        assert got["image"].dtype == want["image"].dtype
        np.testing.assert_array_equal(got["image"], want["image"])
        # a bare array draws from the transform's own stream
        np.testing.assert_array_equal(got_t.apply(img), want_t.apply(img))


def test_seeded_chain_through_an_imageset_matches_jax():
    imgs, labels = _images(10), list(range(10))

    def chain(m):
        return (m.ImageRandomCrop(16, 16, seed=1) >> m.ImageHFlip(0.5, seed=2)
                >> m.ImageChannelNormalize(123.0, 117.0, 104.0, 58.0, 57.0,
                                           57.0) >> m.ImageMatToTensor())

    got = ImageSet.from_arrays(imgs, labels, num_shards=3).transform(
        chain(tf)).to_dataset().collect()
    want = JaxImageSet.from_arrays(imgs, labels, num_shards=3).transform(
        chain(jtf)).to_dataset().collect()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["x"].dtype == np.float32 and g["x"].shape[1:] == (16, 16, 3)
        np.testing.assert_array_equal(g["x"], w["x"])
        np.testing.assert_array_equal(g["y"], w["y"])
    # applying a Preprocessing to the ImageSet is its transform
    again = chain(tf)(ImageSet.from_arrays(imgs, labels, num_shards=3))
    np.testing.assert_array_equal(again.get_image()[0],
                                  got[0]["x"][0])


def test_record_preprocessing_matches_jax():
    cases = [
        ("ScalarToTensor", (), 3),
        ("SeqToTensor", ((2, 3),), list(range(6))),
        ("SeqToTensor", (), [1.5, 2.5]),
        ("ArrayToTensor", ((3, 2),), np.arange(6)),
        ("TensorToSample", (), np.ones((2, 2))),
    ]
    for name, args, rec in cases:
        got = getattr(common, name)(*args).apply(rec)
        want = getattr(jcommon, name)(*args).apply(rec)
        if isinstance(want, dict):
            np.testing.assert_array_equal(got["x"], want["x"])
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    flp = common.FeatureLabelPreprocessing(common.SeqToTensor((2,)),
                                           common.ScalarToTensor())
    jflp = jcommon.FeatureLabelPreprocessing(jcommon.SeqToTensor((2,)),
                                             jcommon.ScalarToTensor())
    for rec in (([1, 2], 1), [3, 4]):
        got, want = flp.apply(rec), jflp.apply(rec)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    chained = common.Lambda(lambda r: r * 2) >> common.ScalarToTensor() \
        >> common.Lambda(lambda r: r + 1)
    assert isinstance(chained, common.ChainedPreprocessing)
    assert len(chained.transformers) == 3 and chained(4) == 9.0
    with pytest.raises(TypeError, match="not a Preprocessing"):
        common.ChainedPreprocessing([lambda r: r])
    # over an XShards of list shards, record by record
    xs = XShards([[1, 2], [3]])
    assert chained(xs).collect() == [[3.0, 5.0], [7.0]]


def test_a_textset_raises_until_it_is_ported():
    class TextSet:          # the JAX class's name, as a caller passes it
        pass

    with pytest.raises(NotImplementedError, match="item 9"):
        common.ScalarToTensor()(TextSet())


def _png_tree(root, with_classes):
    from PIL import Image
    rng = np.random.default_rng(7)
    paths = []
    for c in (("cat", "dog") if with_classes else ("",)):
        d = os.path.join(root, c)
        os.makedirs(d, exist_ok=True)
        for i in range(3):
            p = os.path.join(d, f"im{i}.png")
            Image.fromarray(rng.integers(0, 256, (12, 10, 3),
                                         dtype=np.uint8)).save(p)
            paths.append(p)
        with open(os.path.join(d, "README.txt"), "w") as f:
            f.write("not an image")
    return paths


@pytest.mark.parametrize("with_label", [False, True])
def test_imageset_read_matches_jax(tmp_path, with_label):
    pytest.importorskip("PIL")
    _png_tree(str(tmp_path), with_label)
    got = ImageSet.read(str(tmp_path), with_label=with_label, num_shards=2)
    want = JaxImageSet.read(str(tmp_path), with_label=with_label,
                            num_shards=2)
    assert got.label_map == want.label_map
    assert got.get_uri() == want.get_uri() and len(got) == len(want)
    assert got.get_label() == want.get_label()
    for g, w in zip(got.get_image(), want.get_image()):
        np.testing.assert_array_equal(g, w)
    ds = got.transform(tf.ImageMatToTensor()).to_dataset()
    x = np.concatenate([s["x"] for s in ds.collect()])
    assert x.shape == (len(got), 12, 10, 3) and x.dtype == np.float32
    if with_label:
        y = np.concatenate([s["y"] for s in ds.collect()])
        assert y.tolist() == [0, 0, 0, 1, 1, 1]


def test_imageset_dataset_feeds_a_fit(tmp_path):
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ResNet,
    )
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    imgs, labels = _images(8, 16, 16), [0, 1] * 4
    ds = ImageSet.from_arrays(imgs, labels).transform(
        tf.ImageChannelNormalize(128.0, 128.0, 128.0, 64.0, 64.0, 64.0)
        >> tf.ImageMatToTensor()).to_dataset()
    torch.manual_seed(0)
    model = ResNet(stage_sizes=(1,), num_classes=2, dtype=torch.float32,
                   device="cpu")
    est = Estimator.from_torch(model, learning_rate=1e-3)
    est.fit(ds, epochs=1, batch_size=4)
    assert np.isfinite(est.train_summary[-1]["loss"])


def test_tf_example_codec_writes_jax_bytes():
    feats = {"img": b"\x00\x01", "label": 7, "w": [1.5, 2.5],
             "ids": [1, 2, 300000], "neg": -3, "name": "abc",
             "arr": np.arange(4, dtype=np.int64)}
    blob = ex.encode_example(feats)
    assert blob == jex.encode_example(feats)
    assert ex.decode_example(blob) == jex.decode_example(blob)
    assert ex.decode_example(blob)["neg"] == [-3]


def test_tfrecord_dataset_round_trips_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (25, 8, 8, 3)).astype(np.uint8)
    schema = {"image": "ndarray", "label": "int", "w": "float",
              "raw": "bytes"}

    def gen():
        for i in range(25):
            yield {"image": imgs[i], "label": i % 3, "w": i / 4,
                   "raw": bytes([i])}

    for writer, name in ((TFRecordDataset, "port"),
                         (JaxTFRecordDataset, "jax")):
        path = writer.write(str(tmp_path / name), gen(), schema,
                            records_per_file=10)
        for reader in (TFRecordDataset, JaxTFRecordDataset):
            blocks = reader.read_as_xshards(path).collect()
            assert [len(b["label"]) for b in blocks] == [10, 10, 5]
            np.testing.assert_array_equal(
                np.concatenate([b["image"] for b in blocks]), imgs)
            assert np.concatenate([b["label"] for b in blocks]).tolist() \
                == [i % 3 for i in range(25)]
            assert blocks[2]["raw"] == [bytes([i]) for i in range(20, 25)]
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax")


def test_parquet_dataset_round_trips_and_jax_reads_it(tmp_path):
    pytest.importorskip("pyarrow")
    rng = np.random.default_rng(1)
    rows = [{"image": rng.integers(0, 255, (4, 5), dtype=np.uint8),
             "boxes": rng.random((i % 3 + 1, 4)).astype(np.float32),
             "label": i % 2} for i in range(7)]
    schema = {"image": {"feature_type": "ndarray", "dtype": "uint8"},
              "boxes": {"feature_type": "ndarray"}, "label": "scalar"}
    path = ParquetDataset.write(str(tmp_path / "pq"), iter(rows), schema,
                                block_size=3)
    for reader in (read_parquet_as_xshards, jax_read_parquet):
        blocks = reader(path).collect()
        assert [len(b["label"]) for b in blocks] == [3, 3, 1]
        np.testing.assert_array_equal(
            np.concatenate([b["image"] for b in blocks]),
            np.stack([r["image"] for r in rows]))
        boxes = [a for b in blocks for a in b["boxes"]]   # ragged: lists
        for got, r in zip(boxes, rows):
            np.testing.assert_array_equal(got, r["boxes"])
    only = read_parquet_as_xshards(path, columns=["label"]).collect()
    assert set(only[0]) == {"label"}
    with pytest.raises(FileExistsError):
        ParquetDataset.write(path, iter(rows), schema,
                             write_mode="errorifexists")


def test_write_from_directory_reads_back(tmp_path):
    pytest.importorskip("pyarrow")
    pytest.importorskip("PIL")
    _png_tree(str(tmp_path / "imgs"), True)
    out = write_from_directory(str(tmp_path / "imgs"),
                               output_path=str(tmp_path / "pq"), seed=3)
    got = read_parquet_as_xshards(out).collect()
    want = jax_read_parquet(out).collect()
    assert sorted(np.concatenate([b["label"] for b in got]).tolist()) == \
        [0, 0, 0, 1, 1, 1]
    assert [list(b["uri"]) for b in got] == [list(b["uri"]) for b in want]
