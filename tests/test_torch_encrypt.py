"""Encryption at rest in the port (analytics_zoo_tpu_torch/serving/
encrypt.py) against the JAX package's (serving/encrypt.py), on the CPU:

* each package decrypts the other's blobs, in AES-256-GCM (``AZTE3``,
  with `cryptography`) and in the standard-library SHAKE-256 + HMAC
  format (``AZTE2``, written when `cryptography` is absent: both
  modules' `AESGCM` set to None); JAX's legacy ``AZTE1`` decrypts in
  the port; the plaintext comes back byte for byte;
* a wrong key raises JAX's ValueError, with its message, in each format;
* `ZooModel.save_model(encrypt_key=)` -> `load_model(decrypt_key=)` and
  `InferenceModel.load_model(decrypt_key=)` are bitwise the model saved
  in the clear; a missing key raises JAX's error;
* `start_serving` with `decryptKeyEnv` serves the encrypted model over
  /predict from one process and from two worker processes, equal to a
  direct predict to 1e-5 (the serving tests' tolerance)."""

import hashlib
import hmac
import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.serving import encrypt as jax_enc
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.serving import (
    InferenceModel,
    InputQueue,
    ServingConfig,
    start_serving,
    stop_serving,
)
from analytics_zoo_tpu_torch.serving import encrypt as enc

from _torch_chronos_cases import one_torch_thread  # noqa: F401

TOL = 1e-5
KEY = "correct horse battery staple"
NCF = dict(user_count=50, item_count=40, class_num=2, user_embed=8,
           item_embed=8, hidden_layers=(16, 8), mf_embed=8)
PLAIN = np.random.default_rng(0).integers(0, 256, 5000, np.uint8).tobytes()


@pytest.fixture(params=["AZTE3", "AZTE2"])
def fmt(request, monkeypatch):
    """The format both packages write: AZTE2 with `AESGCM` absent."""
    if request.param == "AZTE2":
        monkeypatch.setattr(enc, "AESGCM", None)
        monkeypatch.setattr(jax_enc, "AESGCM", None)
    return request.param


def test_blobs_read_both_ways(fmt):
    jax_blob = jax_enc.encrypt_bytes(PLAIN, KEY)
    port_blob = enc.encrypt_bytes(PLAIN, KEY)
    assert enc.format_of(jax_blob) == enc.format_of(port_blob) == fmt
    assert len(port_blob) == len(jax_blob)
    assert enc.decrypt_bytes(jax_blob, KEY) == PLAIN
    assert jax_enc.decrypt_bytes(port_blob, KEY) == PLAIN
    assert enc.is_encrypted(jax_blob) and not enc.is_encrypted(PLAIN)


def test_jax_legacy_azte1_decrypts_in_the_port():
    """JAX writes no AZTE1 any more: the blob is built from its own
    pieces (HMAC-CTR keystream, encrypt-then-MAC), as the legacy writer
    laid it out."""
    salt, nonce = bytes(range(16)), bytes(range(16, 32))
    k_enc, k_mac = jax_enc._derive(KEY, salt)
    ct = jax_enc._xor(PLAIN,
                      jax_enc._legacy_v1_keystream(k_enc, nonce, len(PLAIN)))
    tag = hmac.new(k_mac, nonce + ct, hashlib.sha256).digest()
    blob = b"AZTE1" + salt + nonce + tag + ct
    assert jax_enc.decrypt_bytes(blob, KEY) == PLAIN
    assert enc.decrypt_bytes(blob, KEY) == PLAIN
    assert enc.format_of(blob) == "AZTE1"


def test_wrong_key_raises_jaxs_error(fmt):
    blob = jax_enc.encrypt_bytes(PLAIN, KEY)
    with pytest.raises(ValueError) as jax_err:
        jax_enc.decrypt_bytes(blob, "wrong")
    with pytest.raises(ValueError) as port_err:
        enc.decrypt_bytes(blob, "wrong")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="not an AZTE-encrypted blob"):
        enc.decrypt_bytes(PLAIN, KEY)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One NeuralCF saved in the clear and encrypted, with a batch and
    its direct predictions."""
    torch.manual_seed(0)
    model = NeuralCF(**NCF, device="cpu")
    plain = str(tmp_path_factory.mktemp("plain"))
    locked = str(tmp_path_factory.mktemp("locked"))
    model.save_model(plain)
    model.save_model(locked, encrypt_key=KEY)
    rng = np.random.default_rng(2)
    u = rng.integers(1, NCF["user_count"] + 1, 6).astype(np.int32)
    i = rng.integers(1, NCF["item_count"] + 1, 6).astype(np.int32)
    with torch.no_grad():
        want = model(torch.from_numpy(u), torch.from_numpy(i)).numpy()
    return model, plain, locked, u, i, want


def test_encrypted_save_load_round_trip_is_bitwise(saved, tmp_path):
    model, plain, locked, u, i, _ = saved
    assert sorted(os.listdir(locked)) == ["config.pkl", "weights.pt.enc"]
    with open(os.path.join(locked, "weights.pt.enc"), "rb") as f:
        assert enc.is_encrypted(f.read())
    back = NeuralCF.load_model(locked, decrypt_key=KEY, device="cpu")
    for (name, a), b in zip(back.state_dict().items(),
                            model.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="encrypted at rest; pass "
                                         "decrypt_key"):
        NeuralCF.load_model(locked, device="cpu")
    with pytest.raises(ValueError, match="wrong key"):
        NeuralCF.load_model(locked, decrypt_key="wrong", device="cpu")
    np.testing.assert_array_equal(
        InferenceModel().load_model(locked, decrypt_key=KEY,
                                    device="cpu").predict(u, i),
        InferenceModel().load_model(plain, device="cpu").predict(u, i))
    # a re-save in the clear removes the encrypted variant, and back
    d = str(tmp_path / "resave")
    model.save_model(d, encrypt_key=KEY)
    model.save_model(d)
    assert sorted(os.listdir(d)) == ["config.pkl", "weights.pt"]
    model.save_model(d, encrypt_key=KEY)
    assert sorted(os.listdir(d)) == ["config.pkl", "weights.pt.enc"]


@pytest.mark.parametrize("replicas", [1, 2])
def test_start_serving_with_decrypt_key_env(saved, replicas, monkeypatch):
    _, _, locked, u, i, want = saved
    monkeypatch.setenv("ZOO_TEST_MODEL_KEY", KEY)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    servers = start_serving(ServingConfig(
        modelPath=locked, port=0, batchTimeoutMs=1.0, replicas=replicas,
        decryptKeyEnv="ZOO_TEST_MODEL_KEY"), device="cpu")
    try:
        srv = servers["http"]
        got = InputQueue(srv.host, srv.port).predict(u, i, batched=True)
        np.testing.assert_allclose(got, want, atol=TOL)
        assert ("pool" in servers) == (replicas > 1)
    finally:
        stop_serving(servers)
