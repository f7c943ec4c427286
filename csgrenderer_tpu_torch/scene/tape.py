"""CSG tree -> flattened postfix instruction tape.

Twin of ``csgrenderer_tpu/scene/tape.py``. ``compile_tape`` flattens a
``SceneGraph`` root into a ``CompiledTape``:

- **static** (plain Python): the postfix opcode stream ``ops``, the leaf
  primitive types, each leaf's chain of edges up to the root, the
  interval capacity ``k`` and the stack depth;
- **tensors** (on ``device``): leaf parameters, per-edge orientation
  quaternions and offsets, the baked world->local leaf transforms and the
  materials.

Edge semantics (``Wo_Node_Argument``, renderer.h:22-27): a child sits in
its parent's frame at ``p_parent = rotate(q_edge, p_child) + offset_edge``.
``rebake`` composes the edges root to leaf and stores, per leaf, the
world->local quaternion ``leaf_rot`` and the world-space origin
``leaf_pos``, so an evaluator computes ``p_local = rotate(leaf_rot,
p - leaf_pos)``. Animated scenes replace the edge tensors with
``with_edges``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch
from torch import Tensor

from ..math import quaternion as quat
from .graph import BINOP_TYPES, LEAF_TYPES, NodeType, SceneGraph

OP_PUSH = 0
OP_UNION = 1
OP_INTERSECT = 2
OP_DIFF = 3

_BINOP_OPCODE = {
    NodeType.UNION_OF: OP_UNION,
    NodeType.INTERSECTION_OF: OP_INTERSECT,
    NodeType.DIFFERENCE_OF: OP_DIFF,
}

STATIC_FIELDS = ("ops", "leaf_types", "leaf_chains", "k", "stack_depth")


@dataclass(frozen=True)
class CompiledTape:
    """Flattened CSG program plus its tensors. See the module docstring."""

    ops: tuple  # ((opcode, operand), ...)
    leaf_types: tuple  # (int NodeType, ...) per leaf
    leaf_chains: tuple  # per leaf: edge ids, root to leaf
    k: int  # interval-list capacity of the reference evaluator
    stack_depth: int
    leaf_params: Tensor  # [L, 4] f32
    edge_quat: Tensor  # [E, 4] f32 (local -> parent)
    edge_off: Tensor  # [E, 3] f32
    leaf_rot: Tensor  # [L, 4] f32 (world -> local)
    leaf_pos: Tensor  # [L, 3] f32 (leaf origin, world)
    mat_kind: Tensor  # [L] int32
    albedo: Tensor  # [L, 3] f32
    mat_param: Tensor  # [L] f32

    def __post_init__(self):
        set_ = object.__setattr__
        set_(self, "ops", tuple((int(o), int(a)) for o, a in self.ops))
        set_(self, "leaf_types", tuple(int(t) for t in self.leaf_types))
        set_(self, "leaf_chains", tuple(tuple(int(e) for e in c) for c in self.leaf_chains))
        set_(self, "k", int(self.k))
        set_(self, "stack_depth", int(self.stack_depth))

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_types)

    @property
    def device(self) -> torch.device:
        return self.leaf_params.device

    def to(self, device) -> "CompiledTape":
        return replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in fields(self) if f.name not in STATIC_FIELDS
        })

    def rebake(self) -> "CompiledTape":
        """Recompute the leaf world->local transforms from the edge tensors.

        All chains advance together, one edge per step; a chain shorter than
        the longest is padded with the identity edge, which leaves its
        rotation and offset unchanged.
        """
        n_leaves, dev = self.n_leaves, self.device
        depth = max((len(c) for c in self.leaf_chains), default=0)
        e = self.edge_quat.shape[0]
        edge_q = torch.cat([self.edge_quat, quat.identity(device=dev)[None]])
        edge_t = torch.cat([self.edge_off, self.edge_off.new_zeros((1, 3))])
        idx = torch.tensor(
            [list(c) + [e] * (depth - len(c)) for c in self.leaf_chains],
            dtype=torch.int64, device=dev,
        ).reshape(n_leaves, depth)
        q = quat.identity(device=dev).expand(n_leaves, 4)
        t = torch.zeros((n_leaves, 3), dtype=torch.float32, device=dev)
        for j in range(depth):  # root-to-leaf order
            t = quat.rotate(q, edge_t[idx[:, j]]) + t
            q = quat.multiply(q, edge_q[idx[:, j]])
        return replace(self, leaf_rot=quat.conjugate(q).contiguous(), leaf_pos=t.contiguous())

    def with_edges(self, edge_quat: Tensor, edge_off: Tensor) -> "CompiledTape":
        """New tape with replaced edge transforms, re-baked."""
        return replace(self, edge_quat=edge_quat, edge_off=edge_off).rebake()


def compile_tape(graph: SceneGraph, root: int, k: int = 8, device=None) -> CompiledTape:
    """Post-order flatten of ``root``'s subtree into a CompiledTape on ``device``."""
    ops: list[tuple[int, int]] = []
    leaf_types: list[int] = []
    leaf_params: list[list[float]] = []
    leaf_chains: list[tuple[int, ...]] = []
    mats: list = []
    edge_quat: list = []
    edge_off: list = []

    def walk(node: int, chain: tuple[int, ...], depth: int) -> None:
        # cycle guard: any true tree's depth is below its node count
        if depth > graph.node_count:
            raise RecursionError("CSG tree too deep (cycle?)")
        ntype = graph.node_type[node]
        info = graph.node_info[node]
        if ntype in LEAF_TYPES:
            leaf_idx = len(leaf_types)
            leaf_types.append(int(ntype))
            leaf_params.append(_pack_params(ntype, info))
            leaf_chains.append(chain)
            mats.append(graph.material[node])
            ops.append((OP_PUSH, leaf_idx))
        elif ntype in BINOP_TYPES:
            left, right = info
            for arg in (left, right):
                e = len(edge_quat)
                edge_quat.append(list(arg.orientation))
                edge_off.append(list(arg.offset))
                walk(arg.node, chain + (e,), depth + 1)
            ops.append((_BINOP_OPCODE[ntype], 0))
        else:  # pragma: no cover
            raise ValueError(f"unknown node type {ntype}")

    walk(root, (), 0)
    max_depth = stack_depth(ops)

    n_leaves, n_edges = len(leaf_types), len(edge_quat)

    def f32(rows, width):
        arr = np.asarray(rows, np.float32).reshape(len(rows), width)
        return torch.from_numpy(arr).to(device)

    tape = CompiledTape(
        ops=ops,
        leaf_types=leaf_types,
        leaf_chains=leaf_chains,
        k=k,
        stack_depth=max_depth,
        leaf_params=f32(leaf_params, 4),
        edge_quat=f32(edge_quat, 4) if n_edges else torch.zeros((0, 4), device=device),
        edge_off=f32(edge_off, 3) if n_edges else torch.zeros((0, 3), device=device),
        leaf_rot=torch.zeros((n_leaves, 4), device=device),
        leaf_pos=torch.zeros((n_leaves, 3), device=device),
        mat_kind=torch.tensor([m.kind for m in mats], dtype=torch.int32, device=device),
        albedo=f32([list(m.albedo) for m in mats], 3),
        mat_param=torch.tensor([m.param for m in mats], dtype=torch.float32, device=device),
    )
    return tape.rebake()


def stack_depth(ops) -> int:
    """The deepest stack a postfix program reaches; raises if it does not
    end with exactly one value."""
    depth = deepest = 0
    for opcode, _ in ops:
        depth += 1 if opcode == OP_PUSH else -1
        deepest = max(deepest, depth)
    if depth != 1:
        raise AssertionError("malformed tape")
    return deepest


def _pack_params(ntype: NodeType, info) -> list[float]:
    """Leaf params -> fixed [4] layout."""
    p = [0.0, 0.0, 0.0, 0.0]
    if ntype == NodeType.SPHERE:
        p[0] = info[0]
    elif ntype == NodeType.INFINITE_PLANAR_PARTITION:
        n = np.asarray(info[:3], np.float64)
        n = n / max(float(np.linalg.norm(n)), 1e-12)
        p[:3] = n.tolist()
    elif ntype == NodeType.BOX:
        p[:3] = list(info[:3])
    elif ntype == NodeType.CYLINDER:
        p[0], p[1] = info[0], info[1]
    return p
