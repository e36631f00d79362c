"""The port's native host kernels (analytics_zoo_tpu_torch/native/)
against the JAX package's (analytics_zoo_tpu/native/) and the port's
plain versions, on the CPU.  `g++` is on this machine, so both
libraries build here (the port's into `.kernel_build/`, keyed by a hash
of its source).

* `crc32c` equals JAX's and the plain table at every length class, with
  a carried initial value, and the known answer of b"123456789";
* the port's `utils/tfrecord.crc32c` takes the native path once the
  library is loaded, and frames the metrics-history sample the same;
* `tfrecord_scan` and `csv_to_f32` equal JAX's and their plain
  versions, and refuse the same corrupt inputs;
* the library's name changes with its source (a stale build is never
  loaded), and workers racing to build it never load half a file.

Everything compared here is exact (integers, or float32 parses of the
same text)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from analytics_zoo_tpu import native as jax_native
from analytics_zoo_tpu.utils import tfrecord as jax_tfrecord
from analytics_zoo_tpu_torch import native
from analytics_zoo_tpu_torch.utils import tfrecord

ROOT = Path(__file__).resolve().parents[1]


def test_the_library_builds_into_kernel_build_and_loads():
    assert native.available()
    path = native.library_path()
    assert path.parent == ROOT / ".kernel_build"
    assert path.is_file() and path.name.startswith("libzoo_native-")


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1024, 100_001])
def test_crc32c_equals_jax_and_the_plain_table(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    want = jax_tfrecord._py_crc32c(data)
    assert native.crc32c(data) == want
    assert jax_native.crc32c(data) == want
    assert tfrecord.py_crc32c(data) == want
    # a carried initial value, as the stream log chains header and body
    mid = n // 2
    assert native.crc32c(data[mid:], native.crc32c(data[:mid])) == want


def test_crc32c_known_answer_and_the_tfrecord_dispatch():
    assert native.crc32c(b"123456789") == 0xE3069283
    assert tfrecord.crc32c(b"123456789") == 0xE3069283
    big = os.urandom(1 << 20)
    assert tfrecord.crc32c(big) == tfrecord.py_crc32c(big)
    # a large input loads the library; from then on small ones take the
    # native path too
    assert tfrecord._native_crc is native.crc32c
    assert tfrecord.masked_crc32c(b"abc") == jax_tfrecord.masked_crc32c(
        b"abc")


def test_history_frames_stay_byte_identical():
    """A metrics-history frame's CRC through the native path is the one
    the Python table gave (the frames `test_torch_history_alerts.py`
    pins against JAX's)."""
    from analytics_zoo_tpu_torch.observability import history
    payload = os.urandom(4300)          # about one 4.2 KB sample
    assert history.crc32c(payload) == tfrecord.py_crc32c(payload)


def _tfrecord_file(tmp_path, payloads):
    p = str(tmp_path / "x.tfrecord")
    with tfrecord.TFRecordWriter(p) as w:
        for rec in payloads:
            w.write(rec)
    with open(p, "rb") as f:
        return f.read()


def test_tfrecord_scan_equals_jax_and_the_plain_scan(tmp_path):
    rng = np.random.default_rng(1)
    payloads = [b"a" * 5, b"bb" * 50, b""] + [
        rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
        for k in rng.integers(0, 5000, 20)]
    buf = _tfrecord_file(tmp_path, payloads)
    idx = native.tfrecord_scan(buf)
    assert idx == jax_native.tfrecord_scan(buf) \
        == native.py_tfrecord_scan(buf)
    assert [buf[o:o + n] for o, n in idx] == payloads
    bad = bytearray(buf)
    bad[20] ^= 0xFF
    for scan in (native.tfrecord_scan, native.py_tfrecord_scan,
                 jax_native.tfrecord_scan):
        with pytest.raises(IOError, match="corrupt"):
            scan(bytes(bad))


def test_csv_to_f32_equals_jax_and_the_plain_parse():
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((50, 7)).astype(np.float32)
    text = "\n".join(",".join(repr(float(v)) for v in row)
                     for row in vals).encode() + b"\n"
    got = native.csv_to_f32(text, cols=7)
    np.testing.assert_array_equal(got, jax_native.csv_to_f32(text, 7))
    np.testing.assert_array_equal(got, native.py_csv_to_f32(text, 7))
    np.testing.assert_array_equal(got, vals)
    np.testing.assert_array_equal(
        native.csv_to_f32(b"1.5;2;3\n-4;5e-1;6\n", 3, sep=b";"),
        [[1.5, 2, 3], [-4, 0.5, 6]])
    for bad in (b"1,notanumber,3\n", b"1,2,\n3\n"):
        with pytest.raises(ValueError):
            native.csv_to_f32(bad, cols=3)
        with pytest.raises(ValueError):
            native.py_csv_to_f32(bad, cols=3)


def test_the_library_name_follows_the_source(monkeypatch, tmp_path):
    src = tmp_path / "zoo_native.cpp"
    src.write_bytes(native.SRC.read_bytes())
    monkeypatch.setattr(native, "SRC", src)
    before = native.library_path()
    src.write_bytes(native.SRC.read_bytes() + b"\n// edited\n")
    assert native.library_path() != before


def test_racing_builds_load_one_whole_library(tmp_path):
    """Four fresh interpreters build the same source into an empty
    directory at once: each loads a whole library and computes the known
    answer (the compiler writes a temporary file that `os.replace`
    installs)."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from analytics_zoo_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "assert native.available()\n"
        "print(native.crc32c(b'123456789'))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4
    assert all(int(o) == 0xE3069283 for o in outs)
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path().name]
