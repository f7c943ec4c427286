"""ctypes binding to the native C++ scene core (``native/scene_core.cpp``).

Twin of ``csgrenderer_tpu/scene/native.py``. ``NativeSceneGraph`` has the
authoring API of the Python ``SceneGraph`` but keeps the node tables and
the tape compiler in the C++ arena, the counterpart of the reference's
native scene component (renderer.c:176-202, 2220-2313). ``compile()``
returns the same ``CompiledTape`` as the Python compiler, so the tape
evaluator, the kernels and the demos take either.

The C++ core composes each leaf's world->local transform root to leaf in
float64; ``compile`` keeps that bake (rounded to float32) rather than
rebaking in torch, so its tape equals the JAX package's native tape bit
for bit.

``ensure_built()`` compiles the shared ``native/scene_core.cpp`` at first
use, with the flags of ``native/Makefile`` (``-ffp-contract=off`` keeps the
float64 bake free of fused multiply-adds), into this package's
``kernels/_build/libcsgr_scene-<hash>.so``: the hash covers the source and
the flags, and the library is written to a temporary file and renamed, so
concurrent processes never load a half-written one. The compiler is
``$CXX``, else ``g++``, else ``c++``; without one ``ensure_built`` raises
and nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..kernels import build
from .graph import Material, NodeType, _as_arg
from .tape import CompiledTape

SOURCE = Path(__file__).resolve().parents[2] / "native" / "scene_core.cpp"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-ffp-contract=off")


def find_cxx() -> str:
    """The C++ compiler: ``$CXX``, else ``g++``, else ``c++`` on PATH."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler for the native scene core (set CXX or put g++ on PATH)")


def ensure_built() -> Path:
    """Compile ``native/scene_core.cpp`` unless a library of the same hash
    exists; returns the library's path (under ``kernels/_build/``)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    out = build.BUILD_DIR / f"libcsgr_scene-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.compile_into(out, [find_cxx(), *CXXFLAGS, "-shared"], SOURCE)
    return out


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(ensure_built()))
    d = ctypes.POINTER(ctypes.c_double)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.csgr_scene_new.restype = ctypes.c_void_p
    lib.csgr_scene_new.argtypes = [ctypes.c_int64]
    lib.csgr_scene_del.restype = None
    lib.csgr_scene_del.argtypes = [ctypes.c_void_p]
    lib.csgr_scene_error.restype = ctypes.c_int32
    lib.csgr_scene_error.argtypes = [ctypes.c_void_p]
    lib.csgr_scene_node_count.restype = ctypes.c_int64
    lib.csgr_scene_node_count.argtypes = [ctypes.c_void_p]
    lib.csgr_add_leaf.restype = ctypes.c_int32
    lib.csgr_add_leaf.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, d, ctypes.c_int32, d, ctypes.c_double,
    ]
    lib.csgr_add_binop.restype = ctypes.c_int32
    lib.csgr_add_binop.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, d, d, ctypes.c_int32, d, d,
    ]
    lib.csgr_is_root.restype = ctypes.c_int32
    lib.csgr_is_root.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.csgr_compile.restype = ctypes.c_void_p
    lib.csgr_compile.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.csgr_program_sizes.restype = None
    lib.csgr_program_sizes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.csgr_program_read.restype = None
    lib.csgr_program_read.argtypes = [
        ctypes.c_void_p, i32, i32, i32, d, d, d, i32, d, d, d, d, i32, i32,
    ]
    lib.csgr_program_del.restype = None
    lib.csgr_program_del.argtypes = [ctypes.c_void_p]
    return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeSceneGraph:
    """C++-backed SceneGraph with the same authoring API."""

    def __init__(self, max_node_count: int = 64, name: str = "scene"):
        self._lib = _load()
        self.max_node_count = max_node_count
        self.name = name
        self._h = ctypes.c_void_p(self._lib.csgr_scene_new(max_node_count))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.csgr_scene_del(self._h)
            self._h = None

    def _check(self, node_id: int) -> int:
        if node_id < 0:
            err = self._lib.csgr_scene_error(self._h)
            if err == 1:
                raise RuntimeError(f"scene {self.name!r}: node pool exhausted "
                                   f"({self.max_node_count} nodes)")
            raise ValueError(f"bad child node id (native error {err})")
        return node_id

    # -- leaves --
    def _add_leaf(self, ntype, params4, mat: Material | None) -> int:
        mat = mat or Material.normal_map()
        p = np.zeros(4, np.float64)
        p[: len(params4)] = params4
        alb = np.asarray(mat.albedo, np.float64)
        return self._check(self._lib.csgr_add_leaf(
            self._h, int(ntype), _dptr(p), int(mat.kind), _dptr(alb), float(mat.param)))

    def add_sphere_node(self, radius: float, material: Material | None = None) -> int:
        return self._add_leaf(NodeType.SPHERE, [float(radius)], material)

    def add_infinite_planar_partition_node(
        self, outward_facing_normal: Sequence[float], material: Material | None = None
    ) -> int:
        n = np.asarray(outward_facing_normal, np.float64)
        n = n / max(float(np.linalg.norm(n)), 1e-12)
        return self._add_leaf(NodeType.INFINITE_PLANAR_PARTITION, n.tolist(), material)

    def add_box_node(self, half_extents, material: Material | None = None) -> int:
        return self._add_leaf(NodeType.BOX, np.asarray(half_extents, np.float64).tolist(),
                              material)

    def add_cylinder_node(self, radius, half_height, material: Material | None = None) -> int:
        return self._add_leaf(NodeType.CYLINDER, [float(radius), float(half_height)], material)

    # -- binops --
    def _add_binop(self, ntype, left, right) -> int:
        left, right = _as_arg(left), _as_arg(right)
        lq, lo, rq, ro = (np.asarray(v, np.float64) for v in (
            left.orientation, left.offset, right.orientation, right.offset))
        return self._check(self._lib.csgr_add_binop(
            self._h, int(ntype), int(left.node), _dptr(lq), _dptr(lo),
            int(right.node), _dptr(rq), _dptr(ro)))

    def add_union_of_node(self, left, right) -> int:
        return self._add_binop(NodeType.UNION_OF, left, right)

    def add_intersection_of_node(self, left, right) -> int:
        return self._add_binop(NodeType.INTERSECTION_OF, left, right)

    def add_difference_of_node(self, left, right) -> int:
        return self._add_binop(NodeType.DIFFERENCE_OF, left, right)

    # -- queries --
    def is_root(self, node: int) -> bool:
        r = self._lib.csgr_is_root(self._h, int(node))
        if r < 0:
            raise ValueError(f"bad node id {node}")
        return bool(r)

    @property
    def node_count(self) -> int:
        return int(self._lib.csgr_scene_node_count(self._h))

    # -- compile --
    def compile(self, root: int, k: int = 8, device=None) -> CompiledTape:
        """The postfix tape of ``root``'s subtree, its tensors on ``device``;
        the leaf transforms are the C++ core's float64 bake."""
        ph = ctypes.c_void_p(self._lib.csgr_compile(self._h, int(root)))
        try:
            sizes = (ctypes.c_int64 * 6)()
            self._lib.csgr_program_sizes(ph, sizes)
            n_ops, n_leaves, n_edges, n_chain, stack_depth, err = (int(s) for s in sizes)
            if err:
                raise ValueError(f"native compile failed (error {err})")
            ops = np.zeros(n_ops, np.int32)
            operands = np.zeros(n_ops, np.int32)
            leaf_types = np.zeros(n_leaves, np.int32)
            leaf_params = np.zeros(n_leaves * 4, np.float64)
            leaf_rot = np.zeros(n_leaves * 4, np.float64)
            leaf_pos = np.zeros(n_leaves * 3, np.float64)
            mat_kind = np.zeros(n_leaves, np.int32)
            albedo = np.zeros(n_leaves * 3, np.float64)
            mat_param = np.zeros(n_leaves, np.float64)
            edge_quat = np.zeros(max(n_edges, 1) * 4, np.float64)
            edge_off = np.zeros(max(n_edges, 1) * 3, np.float64)
            chain_offsets = np.zeros(n_leaves + 1, np.int32)
            chain_edges = np.zeros(max(n_chain, 1), np.int32)
            self._lib.csgr_program_read(
                ph, _iptr(ops), _iptr(operands), _iptr(leaf_types), _dptr(leaf_params),
                _dptr(leaf_rot), _dptr(leaf_pos), _iptr(mat_kind), _dptr(albedo),
                _dptr(mat_param), _dptr(edge_quat), _dptr(edge_off), _iptr(chain_offsets),
                _iptr(chain_edges))
        finally:
            self._lib.csgr_program_del(ph)

        def f32(a, width, rows):
            # float64 -> float32 rounds to nearest, as jnp.asarray(..., float32) does
            return torch.from_numpy(a.reshape(-1, width)[:rows].astype(np.float32)).to(device)

        return CompiledTape(
            ops=tuple(zip(ops.tolist(), operands.tolist())),
            leaf_types=tuple(leaf_types.tolist()),
            leaf_chains=tuple(tuple(chain_edges[chain_offsets[i]:chain_offsets[i + 1]].tolist())
                              for i in range(n_leaves)),
            k=k,
            stack_depth=stack_depth,
            leaf_params=f32(leaf_params, 4, n_leaves),
            edge_quat=f32(edge_quat, 4, n_edges),
            edge_off=f32(edge_off, 3, n_edges),
            leaf_rot=f32(leaf_rot, 4, n_leaves),
            leaf_pos=f32(leaf_pos, 3, n_leaves),
            mat_kind=torch.from_numpy(mat_kind).to(device),
            albedo=f32(albedo, 3, n_leaves),
            mat_param=torch.from_numpy(mat_param.astype(np.float32)).to(device),
        )
