"""The serving front end's support modules in the port, against the JAX
package's on the CPU:

* the codec: base64 ndarrays, base64 images and Arrow tensors encode to
  the same bytes, and each package decodes the other's;
* `ServingConfig`: the same keys, defaults, errors and YAML loading;
  `start_serving` refuses a `decryptKeyEnv` naming an unset variable in
  each of the worker-pool, gRPC and both-protocol setups before it
  starts anything (tests/test_torch_stream_serving.py serves those
  setups, tests/test_torch_encrypt.py encrypted weights);
* `start_serving` / `stop_serving` and `python -m
  analytics_zoo_tpu_torch.serving.start -c ... --no-block` serve a saved
  port NeuralCF, whose /predict equals `ZooModel.predict` to 1e-5, and
  free the port when stopped;
* `InferenceModel.load_model` and `load_estimator` predict as the model
  they load;
* the metrics registry's Prometheus text is JAX's, byte for byte, for
  the same counter, gauge and histogram operations.

Every server binds port 0 and is stopped in a `finally` block; every
HTTP call has a timeout of at most 30 s."""

import base64
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.observability.registry import (
    MetricsRegistry as JaxRegistry,
    merged_prometheus_text as jax_merged,
)
from analytics_zoo_tpu.serving import codec as jax_codec
from analytics_zoo_tpu.serving.config import ServingConfig as JaxConfig
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.observability import (
    MetricsRegistry,
    merged_prometheus_text,
)
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.serving import (
    InferenceModel,
    InputQueue,
    ServingConfig,
    start_serving,
    stop_serving,
)
from analytics_zoo_tpu_torch.serving import codec

TOL = 1e-5
HTTP_TIMEOUT = 30.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCF = dict(user_count=50, item_count=40, class_num=2, user_embed=8,
           item_embed=8, hidden_layers=(16, 8), mf_embed=8)


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "int64",
                                   "uint8", "bool"])
def test_ndarray_codec_matches_jax(dtype):
    a = (np.random.default_rng(0).normal(size=(3, 2, 5)) * 9).astype(dtype)
    enc = codec.encode_ndarray(a)
    assert enc == jax_codec.encode_ndarray(a)
    for dec in (codec.decode_ndarray, jax_codec.decode_ndarray):
        got = dec(enc)
        assert got.dtype == a.dtype and np.array_equal(got, a)
    # a non-contiguous view encodes as its contiguous copy
    view = a[:, ::2]
    assert codec.encode_ndarray(view) == jax_codec.encode_ndarray(view)
    assert np.array_equal(codec.decode_ndarray([[1, 2]]), [[1, 2]])


def test_arrow_codec_matches_jax():
    pytest.importorskip("pyarrow")
    arrays = [np.arange(12, dtype=np.float32).reshape(3, 4),
              np.array([[1, 2]], np.int64)]
    blob = codec.encode_arrow_tensors(arrays)
    assert blob == jax_codec.encode_arrow_tensors(arrays)
    for dec in (codec.decode_arrow_tensors, jax_codec.decode_arrow_tensors):
        for got, want in zip(dec(blob), arrays):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_image_codec_matches_jax():
    Image = pytest.importorskip("PIL.Image")
    pixels = np.random.default_rng(1).integers(0, 256, (6, 5, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="PNG")
    png = buf.getvalue()
    enc = codec.encode_image(png, resize=(4, 3))
    assert enc == jax_codec.encode_image(png, resize=(4, 3))
    assert base64.b64decode(enc["image_b64"]) == png
    got = codec.decode_ndarray(enc)
    assert got.shape == (1, 4, 3, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_codec.decode_ndarray(enc))
    full = codec.decode_ndarray(codec.encode_image(png))
    np.testing.assert_array_equal(full[0], pixels.astype(np.float32))


@pytest.mark.parametrize("cfg", [
    {},
    {"modelPath": ""},
    {"modelPath": "m", "protocl": "http"},
    {"modelPath": "m", "protocol": "udp"},
    {"modelPath": "m", "replicas": 0},
    {"modelPath": "m", "port": "eighty"},
], ids=["no_path", "empty_path", "unknown_key", "protocol", "replicas",
        "port"])
def test_config_errors_match_jax(cfg):
    with pytest.raises(ValueError) as want:
        JaxConfig(**cfg)
    with pytest.raises(ValueError) as got:
        ServingConfig(**cfg)
    assert str(got.value) == str(want.value)


def test_config_defaults_and_yaml_match_jax(tmp_path):
    pytest.importorskip("yaml")
    assert ServingConfig(modelPath="m").to_dict() == \
        JaxConfig(modelPath="m").to_dict()
    path = tmp_path / "config.yaml"
    path.write_text("modelPath: /models/ncf\nprotocol: HTTP\nport: 0\n"
                    "modelParallelism: 2\nmaxBatchSize: 64\n"
                    "batchTimeoutMs: 2\n")
    assert ServingConfig.load(str(path)).to_dict() == \
        JaxConfig.load(str(path)).to_dict()
    path.write_text("- a list\n")
    with pytest.raises(ValueError, match="YAML mapping"):
        ServingConfig.load(str(path))


@pytest.mark.parametrize("cfg", [{"replicas": 2}, {"protocol": "grpc"},
                                 {"protocol": "both"}])
def test_start_serving_refuses_what_is_not_ported(cfg, monkeypatch):
    """Encrypted weights are served now (tests/test_torch_encrypt.py);
    what each configuration still refuses, before anything starts, is
    a `decryptKeyEnv` naming an unset variable (JAX config.py:116-123)."""
    monkeypatch.delenv("ZOO_TEST_MODEL_KEY", raising=False)
    with pytest.raises(ValueError, match="environment variable is unset"):
        start_serving(ServingConfig(modelPath="unused", port=0,
                                    decryptKeyEnv="ZOO_TEST_MODEL_KEY",
                                    **cfg), device="cpu")


@pytest.fixture(scope="module")
def saved_ncf(tmp_path_factory):
    torch.manual_seed(0)
    model = NeuralCF(**NCF, device="cpu")
    path = str(tmp_path_factory.mktemp("ncf"))
    model.save_model(path)
    rng = np.random.default_rng(2)
    u = rng.integers(1, NCF["user_count"] + 1, 6).astype(np.int32)
    i = rng.integers(1, NCF["item_count"] + 1, 6).astype(np.int32)
    with torch.no_grad():
        want = model(torch.from_numpy(u), torch.from_numpy(i)).numpy()
    return path, u, i, want


def _refused(port):
    with socket.socket() as s:
        s.settimeout(HTTP_TIMEOUT)
        return s.connect_ex(("127.0.0.1", port)) != 0


def test_start_serving_serves_a_saved_model(saved_ncf):
    path, u, i, want = saved_ncf
    servers = start_serving(ServingConfig(modelPath=path, port=0,
                                          batchTimeoutMs=1.0),
                            device="cpu")
    try:
        srv = servers["http"]
        q = InputQueue(srv.host, srv.port)
        got = q.predict(u, i, batched=True)
        np.testing.assert_allclose(got, want, atol=TOL)
        np.testing.assert_allclose(q.predict(u[0], i[0]), want[0], atol=TOL)
        assert servers["model"].records_served == len(u) + 1
    finally:
        stop_serving(servers)
    assert _refused(srv.port)


def test_start_script_no_block(saved_ncf, tmp_path):
    path, u, i, want = saved_ncf
    cfg = tmp_path / "config.yaml"
    cfg.write_text(f"modelPath: {path}\nport: 0\njobName: ncf-test\n")
    from analytics_zoo_tpu_torch.serving import start
    servers = start.main(["-c", str(cfg), "--no-block", "--device", "cpu"])
    try:
        srv = servers["http"]
        np.testing.assert_allclose(
            InputQueue(srv.host, srv.port).predict(u, i, batched=True),
            want, atol=TOL)
    finally:
        stop_serving(servers)
    assert _refused(srv.port)
    # the module's command line, in a fresh interpreter
    out = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.start",
         "-c", str(cfg), "--no-block", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=HTTP_TIMEOUT * 4,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "serving 'ncf-test' started: {'http':" in out.stdout


def test_load_model_predicts_as_the_saved_model(saved_ncf):
    path, u, i, want = saved_ncf
    im = InferenceModel(max_batch_size=4).load_model(path, device="cpu")
    np.testing.assert_allclose(im.predict(u, i), want, atol=TOL)
    im2 = InferenceModel().load_model(path, model_cls=NeuralCF,
                                      device="cpu")
    np.testing.assert_allclose(im2.predict(u, i), want, atol=TOL)
    # int8 weights: the loaded model quantized as a quantized copy of
    # the module is (tests/test_torch_quantize.py holds both against JAX)
    direct = InferenceModel().load_model(path, device="cpu")
    np.testing.assert_array_equal(
        InferenceModel().load_model(path, quantize=True,
                                    device="cpu").predict(u, i),
        InferenceModel().load_module(direct._module, quantize=True
                                     ).predict(u, i))
    # a key given for weights saved in the clear is not needed, as in JAX
    np.testing.assert_allclose(
        InferenceModel().load_model(path, decrypt_key="k",
                                    device="cpu").predict(u, i),
        want, atol=TOL)


def test_load_estimator_predicts_as_the_estimator():
    torch.manual_seed(1)
    model = NeuralCF(**NCF, device="cpu")
    rng = np.random.default_rng(3)
    u = rng.integers(1, NCF["user_count"] + 1, 32).astype(np.int32)
    i = rng.integers(1, NCF["item_count"] + 1, 32).astype(np.int32)
    y = ((u + i) % 2).astype(np.int32)
    est = Estimator.from_torch(model, learning_rate=1e-2)
    est.fit({"x": [u, i], "y": y}, epochs=1, batch_size=16)
    im = InferenceModel(max_batch_size=8).load_estimator(est)
    want = est.predict({"x": [u, i]}, batch_size=16)
    np.testing.assert_allclose(im.predict(u, i), want, atol=TOL)
    assert not model.training


def _registry_ops(reg):
    c = reg.counter("requests_total", help="requests")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("depth", help="queue depth")
    g.set(7)
    g.inc(-2)
    reg.gauge("live", fn=lambda: 3.25, help="a callback gauge")
    h = reg.histogram("wait_seconds", help="waits", reservoir=16)
    for k, v in enumerate([0.004, 0.25, 0.001, 1.5, 0.02] * 5):
        h.record(v, count=1 + k % 3)
    reg.histogram("idle_seconds", help="never recorded")
    return reg


def test_prometheus_text_matches_jax_bytes():
    port, jax_reg = _registry_ops(MetricsRegistry()), \
        _registry_ops(JaxRegistry())
    assert port.prometheus_text() == jax_reg.prometheus_text()
    other, jax_other = MetricsRegistry(), JaxRegistry()
    other.counter("extra_total").inc(4)
    jax_other.counter("extra_total").inc(4)
    assert merged_prometheus_text(port, other) == \
        jax_merged(jax_reg, jax_other)
