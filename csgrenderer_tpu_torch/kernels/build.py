"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled by ``nvcc`` into ``_build/lib<name>-<hash>.so``, where the hash
covers the source, every header in ``csrc/`` (``*.cuh``, which the
sources include) and the flags: a changed source or header builds anew,
an unchanged one loads the library already there. Nothing includes PyTorch's
headers, so a build takes seconds. This module imports nothing from CUDA
at import time; ``nvcc`` is looked up only when a build is needed.
``bind`` declares a launch function's C signature, and ``check_tensor``
is what every wrapper checks before it passes a pointer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from concurrent.futures import ThreadPoolExecutor
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false",  # no contracted multiply-adds: the plain torch version has none
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the build log
)


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str  # nvcc's output (ptxas register and spill report)


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a half file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return Build(out, time.perf_counter() - t0, proc.stdout + proc.stderr)


@functools.cache
def load(name: str) -> tuple[ctypes.CDLL, Build]:
    """Build (if needed) and load ``csrc/<name>.cu``; one library per process."""
    b = build(name)
    return ctypes.CDLL(str(b.path)), b


def load_all() -> dict[str, Build]:
    """Build every kernel source ``csrc/<name>.cu`` at once (one nvcc
    each, started together), then load each; returns name -> Build."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        loaded = list(pool.map(load, names))  # the compiles overlap; errors raise here
    return {name: b for name, (_, b) in zip(names, loaded)}


@functools.cache
def bind(name: str, symbol: str, argtypes: tuple):
    """(the C function ``symbol`` of ``csrc/<name>.cu`` with its argument
    types declared and an int error code as its result, the library's
    ``csgr_error_string``)."""
    lib, _ = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    lib.csgr_error_string.argtypes = [ctypes.c_int]
    lib.csgr_error_string.restype = ctypes.c_char_p
    return fn, lib.csgr_error_string


def check_tensor(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` has this device, dtype and shape and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
