"""The kernel wrappers' launch path (``kernels/build.Kernel``) and the
sphere kernel's staged tables, on the CPU: no card, no nvcc.

A stub stands in for the ctypes library, so the tests see what a launch
binds, passes and raises; ``torch.cuda``'s device and stream calls are
stubbed the same way. The sphere packer's [S, 8] geometry table and the
shared-memory size the launcher stages are checked on the RTIOW final
scene, the two-sphere scene and a griddable scene at the packer's limits
(a 32 x 32 grid whose cells spill to the globals).
"""

import types

import pytest
import torch

from csgrenderer_tpu_torch.kernels import build
from csgrenderer_tpu_torch.kernels import megakernel as mk
from csgrenderer_tpu_torch.kernels import shard_canary as sc
from csgrenderer_tpu_torch.kernels import tape_kernel as tk
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
from csgrenderer_tpu_torch.kernels.worklist import MAX_CELLS, M_SLOTS
from csgrenderer_tpu_torch.models import rtiow_final_scene, two_spheres_scene
from csgrenderer_tpu_torch.tools import exp_dot_k, exp_gather, exp_slab

WRAPPERS = {
    "sphere": mk, "tape": tk, "mesh": tm, "canary": sc,
    "gather": exp_gather, "slab": exp_slab, "dot_k": exp_dot_k,
}
STREAM = 0x5EED


class StubLibrary:
    """A ctypes library's stand-in: every attribute read is counted, and
    each function records its calls and returns ``returns[name]`` (0)."""

    def __init__(self, returns=None):
        self.reads: dict[str, int] = {}
        self.calls: dict[str, list] = {}
        self.returns = dict(returns or {})
        self.fns: dict = {}

    def __getattr__(self, name):
        if name.startswith("__") or name in ("reads", "calls", "returns", "fns"):
            raise AttributeError(name)
        self.reads[name] = self.reads.get(name, 0) + 1
        if name not in self.fns:
            lib = self

            class Fn:
                argtypes = None
                restype = None

                def __call__(self, *args):
                    if self.argtypes is not None and len(args) != len(self.argtypes):
                        raise TypeError(f"{name}: {len(args)} args, {len(self.argtypes)} argtypes")
                    lib.calls.setdefault(name, []).append(args)
                    return lib.returns.get(name, 0)

            self.fns[name] = Fn()
        return self.fns[name]


def _stub_cuda(monkeypatch, current=0):
    """Stub torch.cuda's current device and stream; record device entries."""
    entered = []

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index=None: types.SimpleNamespace(cuda_stream=STREAM))
    monkeypatch.setattr(torch.cuda, "device", Device)
    return entered


def _stub_library(monkeypatch, returns=None):
    lib = StubLibrary({"csgr_tape_max_leaves": tk.MAX_LEAVES, "csgr_tape_max_stack": tk.MAX_STACK,
                       "csgr_tape_max_k": tk.MAX_K, **(returns or {})})
    loads = []

    def load(name):
        loads.append(name)
        return lib, None

    monkeypatch.setattr(build, "load", load)
    return lib, loads


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_refuses_cpu_and_meta_tensors(name):
    """A tensor that is not on a CUDA device is refused with the words every
    wrapper used before the helper."""
    kernel = WRAPPERS[name]._KERNEL
    assert kernel.name == name
    for device in (torch.device("cpu"), torch.device("meta")):
        with pytest.raises(ValueError, match=rf"^the {name} kernel needs CUDA tensors, got "
                                             rf"{device.type}$"):
            kernel.require_cuda(device)
    kernel.require_cuda(torch.device("cuda", 0))  # a CUDA device passes without asking CUDA


def test_wrappers_refuse_meta_before_launching():
    x = torch.zeros(sc.SHAPE, device="meta")
    with pytest.raises(ValueError, match="the canary kernel needs CUDA tensors, got meta"):
        sc._launch(x)
    packed = mk.pack_scene(two_spheres_scene()).to("meta")
    with pytest.raises(ValueError, match="the sphere kernel needs CUDA tensors, got meta"):
        mk._launch(packed, torch.zeros(mk.CAM_SIZE, device="meta"), 8, 4, 1, 1, 0, 0, False,
                   "rtiow", False)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_symbol_bound_once(monkeypatch, name):
    """The C symbol is resolved at the first launch and kept: after several
    launches the library was loaded once and the symbol read once, and every
    launch passed its arguments and the current stream."""
    kernel = WRAPPERS[name]._KERNEL
    monkeypatch.setattr(kernel, "fn", None)
    monkeypatch.setattr(kernel, "error_string", None)
    lib, loads = _stub_library(monkeypatch)
    entered = _stub_cuda(monkeypatch)
    args = tuple(range(len(kernel.argtypes) - 1))
    for _ in range(3):
        kernel(torch.device("cuda", 0), *args)
    assert loads == [kernel.source]
    assert lib.reads[kernel.symbol] == 1
    assert lib.calls[kernel.symbol] == [args + (STREAM,)] * 3
    assert entered == []  # the tensor's device is the current one: no context entered


def test_launch_enters_another_device_and_raises_the_c_error(monkeypatch):
    kernel = sc._KERNEL
    monkeypatch.setattr(kernel, "fn", None)
    monkeypatch.setattr(kernel, "error_string", None)
    lib, _ = _stub_library(monkeypatch)
    entered = _stub_cuda(monkeypatch, current=0)
    kernel(torch.device("cuda", 1), 1, 2)
    assert entered == [1]
    lib.returns[kernel.symbol] = 2
    lib.returns["csgr_error_string"] = b"out of memory"
    with pytest.raises(RuntimeError, match=r"^canary kernel launch failed: out of memory \(2\)$"):
        kernel(torch.device("cuda", 0), 1, 2)
    assert entered == [1]


def test_one_device_never_asks_for_the_current_device(monkeypatch):
    """A process that sees one CUDA device launches on it without asking
    which device is current: a tensor there is on the current device."""
    kernel = sc._KERNEL
    monkeypatch.setattr(kernel, "fn", None)
    monkeypatch.setattr(kernel, "one_device", False)
    _stub_library(monkeypatch)
    entered = _stub_cuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def current_device():
        raise AssertionError("asked for the current device")

    monkeypatch.setattr(torch.cuda, "current_device", current_device)
    kernel(torch.device("cuda", 0), 1, 2)
    assert kernel.one_device and entered == []


def test_tape_library_limits_checked_at_binding(monkeypatch):
    monkeypatch.setattr(tk._KERNEL, "fn", None)
    _stub_library(monkeypatch, {"csgr_tape_max_k": tk.MAX_K + 1})
    _stub_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="disagree on the kernel's limits"):
        tk._KERNEL(torch.device("cuda", 0), *range(len(tk._KERNEL.argtypes) - 1))


def _packer_limit_scene():
    """rtiow_final_scene(grid=40): 6,402 spheres on a 32 x 32 grid whose
    overfull cells spill 634 spheres to the globals."""
    return rtiow_final_scene(grid=40)


SCENES = {
    "rtiow": (rtiow_final_scene, 19_456),
    "two-spheres": (two_spheres_scene, 2 * 32),
    "packer-limits": (_packer_limit_scene, 6_402 * 32 + MAX_CELLS * M_SLOTS * 4),
}


@pytest.fixture(scope="module")
def packed_scenes():
    return {name: mk.pack_scene(make()) for name, (make, _) in SCENES.items()}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_geometry_table(packed_scenes, name):
    """The [S, 8] geometry table is columns 0-7 of the [S, 12] table,
    contiguous, at a 16-byte aligned address and a multiple of 16 bytes
    long (the bulk copy's rule); so is the cell table."""
    packed = packed_scenes[name]
    s = packed.scene.num_spheres
    assert packed.geometry.shape == (s, mk.GEOMETRY_WORDS)
    assert packed.geometry.dtype == torch.float32 and packed.geometry.is_contiguous()
    assert torch.equal(packed.geometry, packed.spheres[:, :8])
    assert packed.geometry.data_ptr() % 16 == 0 and packed.geometry.numel() * 4 % 16 == 0
    if packed.grid is not None:
        cells = packed.grid.cell_ids
        assert cells.is_contiguous() and cells.data_ptr() % 16 == 0
        assert cells.shape[1] == M_SLOTS and cells.numel() * 4 % 16 == 0
    moved = packed.to("meta")
    assert moved.geometry.shape == packed.geometry.shape and moved.geometry.device.type == "meta"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shared_memory_size(packed_scenes, name):
    """The launcher stages S x 32 + cx x cz x m x 4 bytes: 19,456 for RTIOW;
    the scene at the packer's limits stages more than an H100 block's
    opt-in 232,448 bytes, so it runs with its tables in global memory."""
    packed = packed_scenes[name]
    s = packed.scene.num_spheres
    cells = 0
    if packed.grid is not None:
        gs = packed.grid.static
        cells = gs.cx * gs.cz * gs.m * 4
    assert packed.table_bytes == s * 32 + cells == SCENES[name][1]
    if name == "packer-limits":
        gs = packed.grid.static
        assert gs.cx * gs.cz == MAX_CELLS and packed.grid.n_globals == 634
        assert packed.table_bytes > 232_448
    else:
        assert packed.table_bytes <= 48 * 1024  # under the default: no opt-in needed


def test_table_limit_asked_once_per_device(monkeypatch):
    """The device's limit is asked of the library once per device index;
    a CUDA error from the query raises."""
    monkeypatch.setattr(mk, "_TABLE_LIMIT", {})
    lib, _ = _stub_library(monkeypatch, {"csgr_sphere_table_limit": 232_440})
    assert [mk.table_limit(0) for _ in range(3)] == [232_440] * 3
    assert lib.calls["csgr_sphere_table_limit"] == [(0,)]
    lib.returns["csgr_sphere_table_limit"] = -101
    with pytest.raises(RuntimeError, match="CUDA error 101"):
        mk.table_limit(1)
