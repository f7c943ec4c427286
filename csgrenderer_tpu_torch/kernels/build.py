"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled by ``nvcc`` into ``_build/lib<name>-<hash>.so``, where the hash
covers the source, every header in ``csrc/`` (``*.cuh``, which the
sources include) and the flags: a changed source or header builds anew,
an unchanged one loads the library already there. Nothing includes PyTorch's
headers, so a build takes seconds. This module imports nothing from CUDA
at import time; ``nvcc`` is looked up only when a build is needed.
``compile_into`` (a compiler run into a temporary file, then renamed)
also builds the native scene core (``scene/native.py``).

``Kernel`` is every wrapper's launch path: it binds its C launch function
at the first launch and keeps it, and each launch then costs a device
compare, a stream lookup and the ctypes call. ``check_tensor`` is what
every wrapper checks before it passes a pointer.

Each kernel module registers its launch counters (``count_launches``);
``launch_counts`` reads them all at once and ``add_launch_counts`` adds
the difference of two readings back, as a frame replayed from a CUDA
graph does with the launches its capture counted.

``stats_launch`` is where a wrapper asks whether a launch that could
count its work stats (``STATS_WORDS``: the kernels' compiled-in stats
mode) does: one launch in ``STATS_EVERY`` while the program's spans
record (``utils/profiling.py``), none while they do not.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from concurrent.futures import ThreadPoolExecutor
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from ..utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false",  # no contracted multiply-adds: the plain torch version has none
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the build log
)


# every kernel module's launch counters, (module, name): an int, or a dict
# of ints by mode
LAUNCH_COUNTERS: list = []

# while spans record, the first launch that could count its stats and every
# STATS_EVERY-th after it run the kernel's stats instantiation
STATS_EVERY = 8
# the int64 words of a stats launch, in the order the kernels write them:
# the warp turns of the segment (bounce) loop, the warp turns of the walk
# loop, the walk's turns summed over the lanes that take them, and the part
# of those lane turns that NEE's shadow rays take
STATS_WORDS = ("segment_warp_steps", "walk_warp_steps", "walk_lane_steps", "shadow_lane_steps")


def stats_launch() -> bool:
    """Whether this launch, which could count its stats, does: the first
    such launch while the spans record and every ``STATS_EVERY``-th after
    it (``profiling.sample``); never while they do not."""
    return profiling.sample(STATS_EVERY)


def count_launches(module_name: str, *names: str) -> None:
    """Register the counters ``names`` of the module ``module_name`` (which
    calls this as it is imported)."""
    module = sys.modules[module_name]
    LAUNCH_COUNTERS.extend((module, name) for name in names)


def launch_counts() -> dict:
    """Every registered counter now: {(module, name, key): n}, with key None
    for an int counter and the mode for a dict's entry."""
    out = {}
    for module, name in LAUNCH_COUNTERS:
        value = getattr(module, name)
        if isinstance(value, dict):
            out.update(((module, name, k), n) for k, n in value.items())
        else:
            out[(module, name, None)] = value
    return out


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` ({(module, name, key): n}, as ``launch_counts`` keys
    them) to the counters."""
    for (module, name, key), n in delta.items():
        if key is None:
            setattr(module, name, getattr(module, name) + n)
        else:
            getattr(module, name)[key] += n


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str  # the compiler's output (nvcc's: the ptxas register and spill report)


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
    return compile_into(out, [find_nvcc(), *NVCC_FLAGS], src)


def compile_into(out: Path, compiler: list, src: Path) -> Build:
    """Run ``[*compiler, "-o", <temp file>, src]`` and move the result to
    ``out`` (in ``BUILD_DIR``); raises RuntimeError with the compiler's
    output if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([*compiler, "-o", tmp, str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler[0]).name} failed on {src.name}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
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


class Kernel:
    """One C launch function ``symbol`` of ``csrc/<source>.cu``, whose
    arguments are ``argtypes`` and then the stream, and whose result is a
    CUDA error code. ``name`` words the errors ("the sphere kernel ...");
    ``check_library(lib)``, if given, runs once at binding and may raise.

    The library is loaded and the symbol resolved at the first launch and
    kept on the object, so a launch looks nothing up. A launch enters the
    tensor's device only when it is not the current one (a process that
    sees one device never asks), and reads the current stream by device
    index. Every launch returns the C side's
    ``cudaGetLastError()``, which a non-zero code turns into RuntimeError:
    a kernel that fails to build or launch raises, it never falls back.
    """

    def __init__(self, source: str, symbol: str, argtypes: tuple, name: str,
                 check_library=None):
        self.source, self.symbol, self.name = source, symbol, name
        self.argtypes = tuple(argtypes) + (ctypes.c_void_p,)  # + the stream
        self.check_library = check_library
        self.fn = None
        self.error_string = None
        self.one_device = False  # the process sees one CUDA device (set at binding)

    def bind(self):
        """Load the library and resolve the symbol (the first launch does)."""
        lib, _ = load(self.source)
        if self.check_library is not None:
            self.check_library(lib)
        fn = getattr(lib, self.symbol)
        fn.argtypes = list(self.argtypes)
        fn.restype = ctypes.c_int
        lib.csgr_error_string.argtypes = [ctypes.c_int]
        lib.csgr_error_string.restype = ctypes.c_char_p
        self.error_string = lib.csgr_error_string
        self.one_device = torch.cuda.device_count() == 1
        self.fn = fn
        return fn

    def require_cuda(self, device: torch.device) -> None:
        """ValueError unless ``device`` is a CUDA device: a CUDA tensor is the
        proof that CUDA is there, so nothing else is asked per launch."""
        if device.type != "cuda":
            raise ValueError(f"the {self.name} kernel needs CUDA tensors, got {device}")

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device`` (a CUDA device with its index, as a
        tensor's) and its current stream."""
        fn = self.fn or self.bind()
        index = device.index
        if self.one_device or index == torch.cuda.current_device():
            rc = fn(*args, torch.cuda.current_stream(index).cuda_stream)
        else:
            with torch.cuda.device(index):
                rc = fn(*args, torch.cuda.current_stream(index).cuda_stream)
        if rc:
            raise RuntimeError(
                f"{self.name} kernel launch failed: {self.error_string(rc).decode()} ({rc})")


def check_tensor(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` has this device, dtype and shape and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
