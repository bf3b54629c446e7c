"""Build the CUDA kernels from ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with
``ctypes`` — no PyTorch headers, so most builds take seconds (K3f's four large
instantiations about a minute).  Libraries go
into ``_build/`` inside the package (listed in ``.gitignore``), named by
a digest of the sources and flags so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the port's CUDA "
        "kernels are compiled from ecog2txt_tpu_torch/csrc at first use"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(name.encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


_BUILD_LOCKS: dict[str, threading.Lock] = {}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per source digest) and load it.
    Threads that ask for one library at once build it once: the second
    waits for the first's build and loads it."""
    source = CSRC_DIR / f"{name}.cu"
    if not source.is_file():
        raise FileNotFoundError(f"kernel source {source} is missing")
    out = BUILD_DIR / f"lib{name}-{_digest(name)}.so"
    with _BUILD_LOCKS.setdefault(name, threading.Lock()):
        if not out.is_file():
            _compile(source, out)
    return ctypes.CDLL(str(out))


def _compile(source: Path, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source.name} "
            f"(exit {proc.returncode}):\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, out)  # atomic: concurrent processes never see half a file


@functools.cache
def device_smem_optin(index: int) -> int:
    """The shared memory (bytes) one block may opt in to on CUDA device
    ``index`` (227 KB on an H100); raises when the runtime cannot say."""
    fn = load_library("device_info").device_smem_optin
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    limit = int(fn(index))
    if limit <= 0:
        raise RuntimeError(f"cannot read the shared memory limit of CUDA device {index}")
    return limit
