"""Build and load the port's native code: CUDA kernels (``csrc/*.cu``) and
host C++ (``csrc/*.cc``).

Counterpart of ``lighthouse_tpu/native/__init__.py``: each source is
compiled (``nvcc`` for ``sm_90a``, or ``g++``) into a shared library with a
plain C interface, cached under ``lighthouse_tpu_torch/_build/`` by a hash
of the source, every ``csrc/`` header it includes, and the flags, and
loaded with ``ctypes``.  Builds happen at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# --split-compile=0: optimize a source's device functions in parallel on
# every host core (the large csrc/bls12_381.cu builds about a third faster)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

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


def _sources(src: Path) -> list[Path]:
    """``src`` and every file under ``csrc/`` it includes, transitively."""
    seen, todo = [], [src]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        todo.extend(CSRC / inc for inc in _INCLUDE.findall(f.read_text())
                    if (CSRC / inc).exists())
    return seen


def build_key(src: Path, flags: tuple[str, ...]) -> str:
    """Hash of ``src``, the headers it includes and the flags: the build
    cache key, so an edited header never loads a stale library."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in _sources(src):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"{name}-{build_key(src, NVCC_FLAGS)}.so"


def build_log(name: str) -> str:
    """nvcc's output (the ``-Xptxas -v`` register and spill report) from
    the build of ``csrc/<name>.cu``; empty before the first build."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _build(cmd: list[str], out: Path, what: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed to build {what} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)


def build_cuda_lib(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing and load it.
    A failed build raises with nvcc's stderr."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    out = _lib_path(name)
    if not out.exists():
        src = CSRC / f"{name}.cu"
        _build([_nvcc(), *NVCC_FLAGS, str(src)], out, f"csrc/{name}.cu")
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = lib
    return lib


def build_host_lib(name: str) -> ctypes.CDLL:
    """Compile the host C++ source ``csrc/<name>.cc`` with ``g++`` if its
    build is missing and load it.  A failed build raises with g++'s
    stderr."""
    key = f"{name}.cc"
    lib = _LOADED.get(key)
    if lib is not None:
        return lib
    src = CSRC / key
    out = BUILD_DIR / f"{name}-host-{build_key(src, GXX_FLAGS)}.so"
    if not out.exists():
        _build(["g++", *GXX_FLAGS, str(src)], out, f"csrc/{key}")
    lib = ctypes.CDLL(str(out))
    _LOADED[key] = lib
    return lib
