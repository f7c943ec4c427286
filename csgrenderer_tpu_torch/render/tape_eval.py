"""Postfix-tape CSG evaluator over batched rays (the plain reference path).

Twin of ``csgrenderer_tpu/render/tape_eval.py``. Runs a ``CompiledTape``
as a stack machine whose values are fixed-capacity interval lists
(``render/interval.py``). Surface attribution: once the nearest surface t*
is known, every leaf scores how close the hit point is to its own surface
(in its local frame) and an argmin picks the owning leaf, whose normal and
material shade the hit.

The CUDA kernel's production mode does not run this evaluator: it runs
the event-flip form (``kernels/tape_kernel.py``), which reaches the same
surfaces without the K-slot capacity. Its audit mode (``with_overflow``)
evaluates these interval lists, and this module is that mode's plain
version.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..math import quaternion as quat
from ..math import vec
from ..scene.graph import NodeType
from ..scene.tape import OP_DIFF, OP_INTERSECT, OP_PUSH, OP_UNION, CompiledTape
from . import intersect, interval

_OP_NAME = {OP_UNION: "union", OP_INTERSECT: "intersect", OP_DIFF: "diff"}


def _leaf_interval(tape: CompiledTape, leaf: int, o: Tensor, d: Tensor):
    """One leaf's (enter, exit) along rays, computed in its local frame."""
    q = tape.leaf_rot[leaf]
    o_l = quat.rotate(q, o - tape.leaf_pos[leaf])
    d_l = quat.rotate(q, d)
    p = tape.leaf_params[leaf]
    t = tape.leaf_types[leaf]
    if t == NodeType.SPHERE:
        return intersect.sphere_interval(o_l, d_l, p[0])
    if t == NodeType.INFINITE_PLANAR_PARTITION:
        return intersect.halfspace_interval(o_l, d_l, p[:3])
    if t == NodeType.BOX:
        return intersect.box_interval(o_l, d_l, p[:3])
    if t == NodeType.CYLINDER:
        return intersect.cylinder_interval(o_l, d_l, p[0], p[1])
    raise ValueError(f"bad leaf type {t}")


def eval_tape_intervals(tape: CompiledTape, o: Tensor, d: Tensor, with_dropped: bool = False):
    """Run the postfix program; returns the root interval list ([..., K] x2).

    ``with_dropped=True`` also returns, per ray, the total of spans dropped
    by the K-slot capacity over every combine (zero: exact for that ray).
    """
    stack: list = []
    dropped = torch.zeros(o.shape[:-1], dtype=torch.int32, device=o.device)
    for opcode, operand in tape.ops:
        if opcode == OP_PUSH:
            enter, exit_ = _leaf_interval(tape, operand, o, d)
            stack.append(interval.single_to_list(enter, exit_, tape.k))
            continue
        right = stack.pop()
        left = stack.pop()
        if with_dropped:
            t_in, t_out, d_ = interval.combine(left, right, op=_OP_NAME[opcode], k=tape.k,
                                               with_dropped=True)
            dropped = dropped + d_
            stack.append((t_in, t_out))
        else:
            stack.append(interval.combine(left, right, op=_OP_NAME[opcode], k=tape.k))
    (result,) = stack
    return (result, dropped) if with_dropped else result


def tape_dropped_spans(tape: CompiledTape, o: Tensor, d: Tensor) -> Tensor:
    """Per-ray count of CSG spans truncated by the K-slot capacity."""
    return eval_tape_intervals(tape, o, d, with_dropped=True)[1]


def _leaf_surface_score_and_normal(tape: CompiledTape, leaf: int, p_world: Tensor):
    """(score [...], world normal [..., 3]); a smaller score is closer to the
    leaf's surface at p_world (the unsigned distance to the finite surface)."""
    q = tape.leaf_rot[leaf]
    p = quat.rotate(q, p_world - tape.leaf_pos[leaf])
    prm = tape.leaf_params[leaf]
    t = tape.leaf_types[leaf]
    if t == NodeType.SPHERE:
        norm = vec.sqrt(vec.dot(p, p))
        score = torch.abs(norm - prm[0])
        n_local = intersect.sphere_normal(p, norm + 1e-12)
    elif t == NodeType.INFINITE_PLANAR_PARTITION:
        n = prm[:3]
        score = torch.abs(vec.dot(p, n))
        n_local = intersect.halfspace_normal(p, n)
    elif t == NodeType.BOX:
        he = prm[:3]
        qv = torch.abs(p) - he  # per-axis overshoot, < 0 inside each slab
        m = torch.clamp(qv, min=0.0)
        outside = vec.sqrt(m[..., 0] * m[..., 0] + m[..., 1] * m[..., 1] + m[..., 2] * m[..., 2])
        inside = torch.clamp(torch.maximum(qv[..., 0], torch.maximum(qv[..., 1], qv[..., 2])), max=0.0)
        score = outside - inside  # the two terms are mutually exclusive
        n_local = intersect.box_normal(p, he)
    elif t == NodeType.CYLINDER:
        r, h = prm[0], prm[1]
        qr = vec.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2) - r
        qy = torch.abs(p[..., 1]) - h
        outside = vec.sqrt(torch.clamp(qr, min=0.0) ** 2 + torch.clamp(qy, min=0.0) ** 2)
        inside = torch.clamp(torch.maximum(qr, qy), max=0.0)
        score = outside - inside
        n_local = intersect.cylinder_normal(p, r, h)
    else:  # pragma: no cover
        raise ValueError(f"bad leaf type {t}")
    return score, quat.rotate(quat.conjugate(q), n_local)


class TapeHit:
    """Plain struct of hit tensors (all leading dims = ray batch)."""

    def __init__(self, t, hit, entering, normal, mat_kind, albedo, mat_param):
        self.t = t
        self.hit = hit
        self.entering = entering
        self.normal = normal  # outward leaf normal, world frame
        self.mat_kind = mat_kind
        self.albedo = albedo
        self.mat_param = mat_param


def tape_nearest_hit(tape: CompiledTape, o: Tensor, d: Tensor, eps: float = 1e-3) -> TapeHit:
    """Full CSG query: nearest surface plus attribution for shading."""
    t_in, t_out = eval_tape_intervals(tape, o, d)
    t_hit, entering, hit = interval.first_surface(t_in, t_out, eps=eps)
    t_safe = torch.where(hit, t_hit, 1.0)
    p = o + t_safe[..., None] * d

    scores, normals = zip(*(_leaf_surface_score_and_normal(tape, leaf, p)
                            for leaf in range(tape.n_leaves)))
    owner = torch.argmin(torch.stack(scores, dim=-1), dim=-1)  # first minimum
    normal = torch.gather(torch.stack(normals, dim=-2), -2,
                          owner[..., None, None].expand(owner.shape + (1, 3)))[..., 0, :]
    return TapeHit(
        t=t_hit,
        hit=hit,
        entering=entering,
        normal=normal,
        mat_kind=tape.mat_kind[owner],
        albedo=tape.albedo[owner],
        mat_param=tape.mat_param[owner],
    )
