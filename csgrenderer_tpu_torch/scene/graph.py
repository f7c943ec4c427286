"""Host-side CSG scene graph: the authoring API.

A copy of ``csgrenderer_tpu/scene/graph.py`` (numpy only), kept here so
that this package runs without the JAX package; ``compile`` calls this
package's ``scene/tape.py::compile_tape``. The C++ arena twin is
``scene/native.py`` (``NativeSceneGraph``).

Mirrors the reference's renderer scene API (``src/wololo/renderer/
renderer.h:22-33``, impl ``renderer.c:2220-2313``): arena-style node tables,
``NodeArgument`` edges carrying an orientation quaternion + offset, sphere /
infinite-planar-partition leaves and union / intersection / difference binary
ops, a non-root bitset maintained exactly like the reference's
(``renderer.c:2228-2230``), and a ``max_node_count`` capacity cap
(``renderer.c:2220-2227``).

Extensions over the reference (required by the benchmark configs and by the
"wired-together" goal in SURVEY.md §0):
- box and cylinder leaves (BASELINE config 3);
- real materials per node (the reference's ``Wo_Material`` typedef exists but
  is never used, ``renderer.h:16``);
- the missing link: ``compile()`` flattens a root into a postfix instruction
  tape consumed on-device (scene/tape.py).

A C++ arena implementation with the same API lives in native/scene_core.cpp
(bound via ctypes in scene/native.py); this Python one is the default and
the behavioral spec.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import NamedTuple, Sequence

import numpy as np


class NodeType(IntEnum):
    # Mirrors the reference NodeType enum (renderer.c:182-188), extended.
    SPHERE = 0
    INFINITE_PLANAR_PARTITION = 1
    BOX = 2
    CYLINDER = 3
    UNION_OF = 4
    INTERSECTION_OF = 5
    DIFFERENCE_OF = 6


LEAF_TYPES = (
    NodeType.SPHERE,
    NodeType.INFINITE_PLANAR_PARTITION,
    NodeType.BOX,
    NodeType.CYLINDER,
)
BINOP_TYPES = (NodeType.UNION_OF, NodeType.INTERSECTION_OF, NodeType.DIFFERENCE_OF)


class Material(NamedTuple):
    """RTIOW material. kind: 0 normal-map, 1 lambertian, 2 metal,
    3 dielectric, 4 emissive."""

    kind: int = 0
    albedo: tuple = (1.0, 1.0, 1.0)
    param: float = 0.0  # metal fuzz or dielectric index of refraction

    @staticmethod
    def normal_map() -> "Material":
        return Material(0, (1.0, 1.0, 1.0), 0.0)

    @staticmethod
    def lambertian(albedo) -> "Material":
        return Material(1, tuple(albedo), 0.0)

    @staticmethod
    def metal(albedo, fuzz: float = 0.0) -> "Material":
        return Material(2, tuple(albedo), float(fuzz))

    @staticmethod
    def dielectric(index_of_refraction: float) -> "Material":
        return Material(3, (1.0, 1.0, 1.0), float(index_of_refraction))

    @staticmethod
    def emissive(color) -> "Material":
        return Material(4, tuple(color), 0.0)


IDENTITY_QUAT = (1.0, 0.0, 0.0, 0.0)
ZERO_VEC = (0.0, 0.0, 0.0)


class NodeArgument(NamedTuple):
    """Edge into a binop: child placed with orientation+offset relative to
    the parent frame (== ``Wo_Node_Argument``, renderer.h:22-27)."""

    node: int
    orientation: tuple = IDENTITY_QUAT  # (w, x, y, z)
    offset: tuple = ZERO_VEC


@dataclass
class SceneGraph:
    """Arena-allocated CSG node tables (parallel arrays, like renderer.c:338-393)."""

    max_node_count: int = 64
    name: str = "scene"
    node_type: list = field(default_factory=list)
    # Per node: leaves -> params tuple; binops -> (left NodeArgument, right NodeArgument)
    node_info: list = field(default_factory=list)
    material: list = field(default_factory=list)
    _nonroot: set = field(default_factory=set)

    # -- allocation (bump, capacity-checked: renderer.c:2220-2227) ----------
    def _allocate(self, ntype: NodeType, info, mat: Material) -> int:
        if len(self.node_type) >= self.max_node_count:
            raise RuntimeError(
                f"scene {self.name!r}: node pool exhausted "
                f"({self.max_node_count} nodes)"
            )
        self.node_type.append(ntype)
        self.node_info.append(info)
        self.material.append(mat)
        return len(self.node_type) - 1

    # -- leaves -------------------------------------------------------------
    def add_sphere_node(self, radius: float, material: Material | None = None) -> int:
        return self._allocate(
            NodeType.SPHERE, (float(radius),), material or Material.normal_map()
        )

    def add_infinite_planar_partition_node(
        self, outward_facing_normal: Sequence[float], material: Material | None = None
    ) -> int:
        n = np.asarray(outward_facing_normal, np.float64)
        return self._allocate(
            NodeType.INFINITE_PLANAR_PARTITION,
            tuple(n.tolist()),
            material or Material.normal_map(),
        )

    def add_box_node(
        self, half_extents: Sequence[float], material: Material | None = None
    ) -> int:
        he = np.asarray(half_extents, np.float64)
        return self._allocate(
            NodeType.BOX, tuple(he.tolist()), material or Material.normal_map()
        )

    def add_cylinder_node(
        self, radius: float, half_height: float, material: Material | None = None
    ) -> int:
        return self._allocate(
            NodeType.CYLINDER,
            (float(radius), float(half_height)),
            material or Material.normal_map(),
        )

    # -- binops (children become non-root: renderer.c:2252-2253) ------------
    def _add_binop(self, ntype: NodeType, left, right) -> int:
        left, right = _as_arg(left), _as_arg(right)
        for arg in (left, right):
            if not (0 <= arg.node < len(self.node_type)):
                raise ValueError(f"bad child node id {arg.node}")
        node = self._allocate(ntype, (left, right), Material.normal_map())
        self._nonroot.add(left.node)
        self._nonroot.add(right.node)
        return node

    def add_union_of_node(self, left, right) -> int:
        return self._add_binop(NodeType.UNION_OF, left, right)

    def add_intersection_of_node(self, left, right) -> int:
        return self._add_binop(NodeType.INTERSECTION_OF, left, right)

    def add_difference_of_node(self, left, right) -> int:
        return self._add_binop(NodeType.DIFFERENCE_OF, left, right)

    # -- queries ------------------------------------------------------------
    def is_root(self, node: int) -> bool:
        """Same contract as wo_renderer_isroot (renderer.c:2309-2313)."""
        if not (0 <= node < len(self.node_type)):
            raise ValueError(f"bad node id {node}")
        return node not in self._nonroot

    def roots(self) -> list[int]:
        return [i for i in range(len(self.node_type)) if i not in self._nonroot]

    def set_material(self, node: int, material: Material) -> None:
        self.material[node] = material

    @property
    def node_count(self) -> int:
        return len(self.node_type)

    # -- the missing link: flatten to a device tape -------------------------
    def compile(self, root: int | None = None, k: int = 8, device=None):
        from .tape import compile_tape

        if root is None:
            rs = self.roots()
            if len(rs) != 1:
                raise ValueError(
                    f"scene has {len(rs)} roots; pass root= explicitly"
                )
            root = rs[0]
        return compile_tape(self, root, k=k, device=device)


def _as_arg(x) -> NodeArgument:
    if isinstance(x, NodeArgument):
        return x
    if isinstance(x, int):
        return NodeArgument(x)
    raise TypeError(f"expected NodeArgument or node id, got {type(x)}")
