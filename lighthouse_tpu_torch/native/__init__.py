"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Counterpart of ``lighthouse_tpu/native/__init__.py``: each source is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, cached under ``lighthouse_tpu_torch/_build/`` by a hash of the
source and flags, and loaded with ``ctypes``.  Builds happen at first use,
never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (searched PATH and $CUDA_HOME/bin)")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (the ``-Xptxas -v`` register and spill report) from
    the build of ``csrc/<name>.cu``; empty before the first build."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_cuda_lib(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing and load it.
    A failed build raises with nvcc's stderr."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    out = _lib_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build csrc/{name}.cu "
                f"(rc {proc.returncode}):\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = lib
    return lib
