"""Builds the package's CUDA kernels with nvcc and loads them with ctypes.

Each source under ``csrc/`` is compiled on first use into a shared library
with a plain C interface, in ``_build/`` beside this file. The file name
carries a hash of the source, of every ``.cuh`` header under ``csrc/`` and
of the flags, so an edited source, header or flag rebuilds and an unchanged
one is loaded from the cache. No ``-lcuda``: the one driver call the
kernels need (``cuTensorMapEncodeTiled``) is found through the runtime's
``cudaGetDriverEntryPoint``. Nothing here runs at import time, and nothing
falls back: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, NamedTuple, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC",
)


class BuildInfo(NamedTuple):
    path: str        # the loaded shared library
    built: bool      # False when it came from the cache
    seconds: float   # build (or load) time


class _Loaded(NamedTuple):
    lib: ctypes.CDLL
    info: BuildInfo


_LOADED: Dict[str, _Loaded] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda); "
        "the CUDA kernels cannot be built"
    )


def _source_key(src: str) -> str:
    """Hash of a source, every header under ``csrc/`` (any of them may be
    included) and the flags: an edited header rebuilds too."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0")
            h.update(f.read() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_kernel_libraries(names: Sequence[str]) -> List[_Loaded]:
    """Build (or load from the cache) ``csrc/<name>.cu`` for every name and
    return the loaded libraries with their build info. The nvcc processes
    of the libraries not yet built all run at once."""
    with _LOCK:
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        jobs = {}  # name -> (lib_path, tmp, cmd, proc); proc None on a hit
        for name in names:
            if name in _LOADED or name in jobs:
                continue
            src = os.path.join(CSRC_DIR, name + ".cu")
            key = _source_key(src)
            lib_path = os.path.join(BUILD_DIR, f"lib{name}_{key}.so")
            if os.path.exists(lib_path):
                jobs[name] = (lib_path, None, None, None)
                continue
            # Compile to a temporary name and rename, so a concurrent or
            # interrupted build never leaves a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (lib_path, tmp, cmd, proc)
        failures = []
        for name, (lib_path, tmp, cmd, proc) in jobs.items():
            if proc is not None:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    os.unlink(tmp)
                    failures.append(f"nvcc failed ({proc.returncode}):\n"
                                    f"{' '.join(cmd)}\n{log}")
                    continue
                os.replace(tmp, lib_path)
            info = BuildInfo(lib_path, proc is not None,
                             time.perf_counter() - t0)
            _LOADED[name] = _Loaded(ctypes.CDLL(lib_path), info)
        if failures:
            raise RuntimeError("\n".join(failures))
        return [_LOADED[name] for name in names]


def load_kernel_library(name: str) -> _Loaded:
    """Build (or load from the cache) ``csrc/<name>.cu`` and return the
    loaded library with its build info."""
    return load_kernel_libraries([name])[0]
