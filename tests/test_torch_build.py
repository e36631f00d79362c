"""The port's CUDA build step (analytics_zoo_tpu_torch/ops/kernels/
_build.py) with a stand-in compiler: the command line it runs, the
source-hash naming that rebuilds an edited source, the cache that skips
a built one, and a failed build raising with the compiler's output and
leaving no partial library behind; and the launch counters staying
exact under concurrent launches.  (The real nvcc runs on the card, in
chip_smoke.py.)"""

import os
import stat
import sys
import threading

import pytest

from analytics_zoo_tpu_torch.ops.kernels import _build


def _fake_nvcc(tmp_path, exit_code=0):
    """A compiler that logs its arguments and writes the -o file."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{tmp_path}/calls"\n'
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi\n'
        "  shift\n"
        "done\n"
        'echo "ptxas info : Used 32 registers"\n'
        f"exit {exit_code}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


@pytest.fixture()
def src_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("extern \"C\" int k() { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_build_names_by_source_hash_and_caches(src_tree, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: _fake_nvcc(src_tree))
    assert _build.cuda_sources() == ["k"]
    logs = _build.build(["k"], extra_flags=["-Xptxas", "-v"])
    assert "Used 32 registers" in logs["k"]
    lib = _build.library_path("k")
    assert lib.exists() and lib.parent == src_tree / "build"
    call = (src_tree / "calls").read_text().split()
    assert call[:2] == ["-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-shared" in call and "-fPIC" in call and "-v" in call
    assert _build.build(["k"]) == {}          # built: nothing to do
    (src_tree / "csrc" / "k.cu").write_text("// edited\n")
    assert _build.library_path("k") != lib    # an edit means a rebuild
    assert "k" in _build.build(["k"])


def test_failed_build_raises_and_leaves_nothing(src_tree, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: _fake_nvcc(src_tree, exit_code=2))
    with pytest.raises(RuntimeError, match="nvcc failed on csrc/k.cu"):
        _build.build(["k"])
    assert not _build.library_path("k").exists()
    assert os.listdir(src_tree / "build") == []
    with pytest.raises(FileNotFoundError):
        _build.build(["missing"])


def test_launch_counts_are_exact_across_threads():
    """Wrappers count launches from several threads at once (predict
    calls of InferenceModel); chip_smoke.py checks the counts exactly,
    so none may be lost."""
    from analytics_zoo_tpu_torch.ops import kernels

    assert sorted(kernels.KERNELS) == [
        "flash_bwd_dbias", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd",
        "fused_dense_gelu", "layer_norm_bwd", "layer_norm_fwd",
        "paged_decode"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as possible
    try:
        def wrapper():
            pass
        wrapper.launches = 0
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(wrapper) for _ in range(20000)])
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 8 * 20000


def test_no_compiler_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
