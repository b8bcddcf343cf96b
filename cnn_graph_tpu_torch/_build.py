"""Build and load the port's CUDA kernels and its host C++.

Each ``csrc/<name>.cu`` has a plain C interface.  On first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``_build/`` next to this file
(listed in ``.gitignore``) and loaded with ``ctypes``.  The library's
file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as built.  ``nvcc`` is found
through ``CUDA_HOME`` or ``PATH``.  ``native/<name>.cpp`` (the host
kernels, ``cnn_graph_tpu_torch.native``) is built the same way with
``g++`` (``build_host``/``load_host``).  A failed build raises with the
compiler's output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "GXX_FLAGS", "build", "load",
           "build_host", "load_host"]

_HERE = Path(__file__).resolve().parent
SOURCE_DIR = _HERE / "csrc"
HOST_SOURCE_DIR = _HERE / "native"
BUILD_DIR = _HERE / "_build"
# No --use_fast_math: the int8 emission must round exactly as IEEE f32.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# No -march=native and no fast math: the host kernels round as NumPy does.
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
            "port's CUDA kernels"
        )
    return found


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: put it on PATH to build the "
                           "port's host kernels (cnn_graph_tpu_torch/native)")
    return found


def _compile(compiler: str, flags: tuple, src: Path,
             headers: bytes) -> tuple[Path, str]:
    """Compile ``src`` with ``compiler`` unless its hashed library
    exists; the hash covers the source, ``headers`` and the flags."""
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(flags).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [compiler, *flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(compiler).name} failed to build {src.name} (exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib, proc.stdout + proc.stderr


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.
    Returns ``(library path, compiler output)``; the output is empty when
    the library was already built."""
    headers = b"".join(h.read_bytes()
                       for h in sorted(SOURCE_DIR.glob("*.cuh")))
    return _compile(_nvcc(), NVCC_FLAGS, SOURCE_DIR / f"{name}.cu", headers)


def build_host(name: str) -> tuple[Path, str]:
    """Compile ``native/<name>.cpp`` with ``g++`` unless its hashed
    library exists; returns as ``build`` does."""
    return _compile(_gxx(), GXX_FLAGS, HOST_SOURCE_DIR / f"{name}.cpp", b"")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for ``native/<name>.cpp``, built on first use."""
    path, _ = build_host(name)
    return ctypes.CDLL(str(path))
