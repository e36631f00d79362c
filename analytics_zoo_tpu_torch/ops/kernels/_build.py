"""Build the port's CUDA sources with `nvcc` and load them with ctypes.

Each `csrc/<name>.cu` exports plain C functions (no PyTorch headers, so
a build takes seconds) and is compiled for Hopper only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o .kernel_build/lib<name>-<hash>.so <name>.cu

into `.kernel_build/` at the checkout's root (listed in .gitignore), on
first use.  The library's file name carries a hash of the source, so an
edited source is rebuilt and a stale library is never loaded.  Only
sources in this package are compiled, and a failed build raises: there
is no fallback to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".kernel_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under CUDA_HOME or
    /usr/local/cuda.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _source(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    return src


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is built to (hash of its source and of
    the headers beside it in the name)."""
    h = hashlib.sha256(_source(name).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, extra_flags: Iterable[str] = ()):
    """Start one nvcc for `name` into a temporary file beside its
    final path; returns (process, tmp, final) or None when built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
           str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)    # atomic: a reader never sees half a file
    return log


def build(names: List[str], extra_flags: Iterable[str] = ()
          ) -> Dict[str, str]:
    """Build every named source that is not built yet, one nvcc each,
    all started together.  Returns {name: compiler output} for the
    sources that were compiled now."""
    extra_flags = list(extra_flags)
    with _lock:
        started = {}
        try:
            for n in names:
                st = _start(n, extra_flags)
                if st is not None:
                    started[n] = st
        except BaseException:
            for proc, tmp, _ in started.values():   # leave no orphans
                proc.kill()
                proc.wait()
                os.unlink(tmp)
            raise
        logs, failed = {}, []
        for n, st in started.items():   # wait for every compiler
            try:
                logs[n] = _finish(n, st)
            except RuntimeError as e:
                failed.append(str(e))
        if failed:
            raise RuntimeError("\n".join(failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


_count_lock = threading.Lock()


def count_launch(wrapper, body: str = None) -> None:
    """Add one to `wrapper.launches` (and to `wrapper.launches_by_body
    [body]` for a kernel with several bodies).  Under a lock: callers
    such as `InferenceModel.predict` launch from several threads, and a
    bare `+= 1` on an attribute can lose counts between threads."""
    with _count_lock:
        wrapper.launches += 1
        if body is not None:
            wrapper.launches_by_body[body] += 1


def cuda_sources() -> List[str]:
    """Names of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
