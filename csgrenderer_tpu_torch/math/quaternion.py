"""Quaternion algebra over ``[..., 4]`` tensors, layout ``(w, x, y, z)``.

Twin of ``csgrenderer_tpu/math/quaternion.py``. Every op broadcasts over
leading batch dimensions. ``rotate`` keeps the reference's expanded form
``v + w*t + u x t`` with ``t = 2 u x v`` and its operation order, which
the CSG kernel (``kernels/csrc/tape_kernel.cu``) repeats.
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import vec


def identity(dtype=torch.float32, device=None) -> Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def from_axis_angle(axis, angle) -> Tensor:
    """Unit quaternion rotating by ``angle`` (radians) about ``axis``."""
    axis = vec.normalized(torch.as_tensor(axis, dtype=torch.float32))
    angle = torch.as_tensor(angle, dtype=torch.float32, device=axis.device)
    half = 0.5 * angle
    w = torch.cos(half)
    xyz = torch.sin(half)[..., None] * axis
    return torch.cat([w[..., None].expand(xyz.shape[:-1] + (1,)), xyz], dim=-1)


def multiply(q: Tensor, r: Tensor) -> Tensor:
    """Hamilton product q*r (apply r's rotation, then q's)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rw, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return torch.stack(
        [
            qw * rw - qx * rx - qy * ry - qz * rz,
            qw * rx + qx * rw + qy * rz - qz * ry,
            qw * ry - qx * rz + qy * rw + qz * rx,
            qw * rz + qx * ry - qy * rx + qz * rw,
        ],
        dim=-1,
    )


def conjugate(q: Tensor) -> Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _cross(ux, uy, uz, vx, vy, vz):
    return uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx


def rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v by unit quaternion(s) q: ``v + w*t + u x t``."""
    w, ux, uy, uz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    cx, cy, cz = _cross(ux, uy, uz, vx, vy, vz)
    tx, ty, tz = 2.0 * cx, 2.0 * cy, 2.0 * cz
    ex, ey, ez = _cross(ux, uy, uz, tx, ty, tz)
    return torch.stack([vx + w * tx + ex, vy + w * ty + ey, vz + w * tz + ez], dim=-1)


def rotate_inverse(q: Tensor, v: Tensor) -> Tensor:
    """Rotate v by the inverse of unit quaternion q (world -> local)."""
    return rotate(conjugate(q), v)


def to_rotation_matrix(q: Tensor) -> Tensor:
    """Unit quaternion -> ``[..., 3, 3]`` rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))
