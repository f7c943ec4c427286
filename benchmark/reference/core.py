"""Plain torch path tracing: the benchmark's own reference.

The reference against which the benchmark holds what the timed path
produced. It imports nothing of the program under test: every function
here is written out in plain torch operations, in the float grouping the
renderer documents for its plain version (dot products summed left to
right, the expanded ray-sphere quadratic, PCG4D counters keyed by pixel,
sample, bounce and seed), so that where the program is right the two agree
pixel for pixel except where a path splits at a silhouette.

Every function takes its float type from its inputs: the scene and the
camera in float32 give the reference, the same in bfloat16 give the
lower-precision control of ``benchmark/control.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Callable, NamedTuple

import torch
from torch import Tensor

MASK = 0xFFFFFFFF
T_FAR = 1e9
T_NEG = -1e9
WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)
JITTER_KEY = 0xA5A5A5A5  # the bounce counter of a sample's pixel jitter and lens uniforms


# ---------------------------------------------------------------------------
# PCG4D counters (Jarzynski & Olano, JCGT 2020), uint32 emulated in int64
# ---------------------------------------------------------------------------


def _u32(x, device) -> Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64) & MASK


def _mul(a: Tensor, b: int) -> Tensor:
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _mul2(a: Tensor, b: Tensor) -> Tensor:
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK


def pcg4d(a, b, c, d) -> list[Tensor]:
    device = next((x.device for x in (a, b, c, d) if isinstance(x, Tensor)), None)
    v = list(torch.broadcast_tensors(*(_u32(x, device) for x in (a, b, c, d))))
    v = [(_mul(x, 1664525) + 1013904223) & MASK for x in v]

    def mix(v):
        v[0] = (v[0] + _mul2(v[1], v[3])) & MASK
        v[1] = (v[1] + _mul2(v[2], v[0])) & MASK
        v[2] = (v[2] + _mul2(v[0], v[1])) & MASK
        v[3] = (v[3] + _mul2(v[1], v[2])) & MASK

    mix(v)
    v = [x ^ (x >> 16) for x in v]
    mix(v)
    return v


def uniform4(a, b, c, d, dtype) -> Tensor:
    """[..., 4] uniforms in [0, 1) from the top 24 bits of each word."""
    return torch.stack([((w >> 8).to(torch.float32) * (1.0 / 16777216.0)).to(dtype)
                        for w in pcg4d(a, b, c, d)], dim=-1)


# ---------------------------------------------------------------------------
# Vectors and quaternions over the trailing axis
# ---------------------------------------------------------------------------


def dot(v: Tensor, w: Tensor) -> Tensor:
    return v[..., 0] * w[..., 0] + v[..., 1] * w[..., 1] + v[..., 2] * w[..., 2]


def sqrt(x: Tensor) -> Tensor:
    """Correctly rounded: torch's float32 sqrt on the CPU is not."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def normalized(v: Tensor, eps: float = 0.0) -> Tensor:
    return v * torch.rsqrt(torch.clamp(dot(v, v), min=eps))[..., None]


def cross(v: Tensor, w: Tensor) -> Tensor:
    v, w = torch.broadcast_tensors(v, w)
    return torch.linalg.cross(v, w, dim=-1)


def reflect(v: Tensor, n: Tensor) -> Tensor:
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: Tensor, n: Tensor, eta: Tensor) -> Tensor:
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    perp = eta[..., None] * (uv + cos_theta[..., None] * n)
    parallel = -torch.sqrt(torch.abs(1.0 - dot(perp, perp)))[..., None] * n
    return perp + parallel


def quat_multiply(q: Tensor, r: Tensor) -> Tensor:
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rw, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return torch.stack([qw * rw - qx * rx - qy * ry - qz * rz,
                        qw * rx + qx * rw + qy * rz - qz * ry,
                        qw * ry - qx * rz + qy * rw + qz * rx,
                        qw * rz + qx * ry - qy * rx + qz * rw], dim=-1)


def quat_conjugate(q: Tensor) -> Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """v + w t + u x t with t = 2 u x v."""
    w, ux, uy, uz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    cx, cy, cz = uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx
    tx, ty, tz = 2.0 * cx, 2.0 * cy, 2.0 * cz
    ex, ey, ez = uy * tz - uz * ty, uz * tx - ux * tz, ux * ty - uy * tx
    return torch.stack([vx + w * tx + ex, vy + w * ty + ey, vz + w * tz + ez], dim=-1)


# ---------------------------------------------------------------------------
# The thin-lens camera (Shirley, Ray Tracing in One Weekend)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Camera:
    origin: Tensor
    lower_left: Tensor
    horizontal: Tensor
    vertical: Tensor
    u: Tensor
    v: Tensor
    lens_radius: Tensor

    @staticmethod
    def look_at(lookfrom, lookat, vfov_degrees: float, aspect_ratio: float,
                aperture: float = 0.0, focus_dist: float | None = None,
                vup=(0.0, 1.0, 0.0), device=None) -> "Camera":
        """Built in float32 on ``device``; ``astype`` gives the control's."""
        f32 = dict(dtype=torch.float32, device=device)
        lookfrom, lookat, vup = (torch.as_tensor(x, **f32) for x in (lookfrom, lookat, vup))
        if focus_dist is None:
            focus_dist = torch.sqrt(dot(lookfrom - lookat, lookfrom - lookat))
        focus_dist = torch.as_tensor(focus_dist, **f32)
        theta = torch.as_tensor(vfov_degrees, **f32) * (math.pi / 180.0)
        viewport_height = 2.0 * torch.tan(theta / 2.0)
        viewport_width = aspect_ratio * viewport_height
        w = normalized(lookfrom - lookat)
        u = normalized(cross(vup, w))
        v = cross(w, u)
        horizontal = focus_dist * viewport_width * u
        vertical = focus_dist * viewport_height * v
        lower_left = lookfrom - horizontal / 2.0 - vertical / 2.0 - focus_dist * w
        return Camera(lookfrom, lower_left, horizontal, vertical, u, v,
                      torch.as_tensor(aperture, **f32) / 2.0)

    def astype(self, dtype) -> "Camera":
        return Camera(**{f.name: getattr(self, f.name).to(dtype) for f in fields(self)})

    def rays(self, st_x: Tensor, st_y: Tensor, lens_uv: Tensor | None):
        if lens_uv is None:
            offset = torch.zeros(st_x.shape + (3,), dtype=st_x.dtype, device=st_x.device)
        else:
            rd = self.lens_radius * lens_uv
            offset = rd[..., 0:1] * self.u + rd[..., 1:2] * self.v
        o = self.origin + offset
        d = (self.lower_left + st_x[..., None] * self.horizontal
             + st_y[..., None] * self.vertical - self.origin - offset)
        return o, d


def pixel_st(xs: Tensor, ys: Tensor, jx, jy, width: int, height: int):
    """Viewport coordinates of pixel (x, y) at jitter (jx, jy): x over the
    width, and y flipped so that row 0 is the top. The divisions are true
    divisions (a divisor tensor), not products with a rounded reciprocal."""
    w = torch.full((), width, dtype=jx.dtype if isinstance(jx, Tensor) else torch.float32,
                   device=xs.device)
    h = torch.full((), height, dtype=w.dtype, device=xs.device)
    return (xs.to(w.dtype) + jx) / w, 1.0 - (ys.to(w.dtype) + jy) / h


# ---------------------------------------------------------------------------
# Materials, sky, and the bounce loop
# ---------------------------------------------------------------------------


class Hit(NamedTuple):
    t: Tensor
    hit: Tensor
    normal: Tensor  # unit, opposing the incoming ray
    front_face: Tensor
    mat_kind: Tensor  # 1 Lambertian, 2 metal, 3 dielectric
    albedo: Tensor
    mat_param: Tensor  # metal fuzz or dielectric index


def sky_color(d: Tensor, mode: str) -> Tensor:
    if mode == "black":
        return torch.zeros(d.shape[:-1] + (3,), dtype=d.dtype, device=d.device)
    if mode != "rtiow":
        raise ValueError(f"the reference has no sky {mode!r}")
    y = normalized(d, eps=1e-20)[..., 1]
    t = 0.5 * (y + 1.0)
    return torch.stack([(1.0 - t) * a + t * b for a, b in zip(WHITE, SKY_BLUE)], dim=-1)


def scatter(h: Hit, d_in: Tensor, u: Tensor):
    """(direction, attenuation, terminate) of the RTIOW materials."""
    n = h.normal
    unit_d = normalized(d_in, eps=1e-20)
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u[..., 1]
    rand_unit = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)

    lam = n + rand_unit
    lam = torch.where((dot(lam, lam) < 1e-12)[..., None], n, lam)

    refl = reflect(unit_d, n)
    metal = refl + h.mat_param[..., None] * rand_unit
    absorbed = dot(metal, n) <= 0.0

    ir = torch.clamp(h.mat_param, min=1e-6)
    eta = torch.where(h.front_face, 1.0 / ir, ir)
    cos_theta = torch.clamp(dot(-unit_d, n), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = eta * sin_theta > 1.0
    q = (1.0 - eta) / (1.0 + eta)
    r0 = q * q
    c1 = 1.0 - cos_theta
    c2 = c1 * c1
    reflect_prob = r0 + (1.0 - r0) * (c2 * c2 * c1)
    use_reflect = cannot_refract | (u[..., 2] < reflect_prob)
    glass = torch.where(use_reflect[..., None], refl, refract(unit_d, n, eta))

    is_lam, is_metal = h.mat_kind == 1, h.mat_kind == 2
    direction = torch.where(is_lam[..., None], lam, torch.where(is_metal[..., None], metal, glass))
    attenuation = torch.where((h.mat_kind == 3)[..., None], torch.ones_like(h.albedo), h.albedo)
    return direction, attenuation, is_metal & absorbed


HitFn = Callable[[Tensor, Tensor], Hit]


def _trace_active(hit_fn: HitFn, o: Tensor, d: Tensor, active: Tensor) -> Hit:
    if bool(active.all()):
        return hit_fn(o, d)
    idx = torch.nonzero(active.reshape(-1))[:, 0]
    h = hit_fn(o.reshape(-1, 3)[idx], d.reshape(-1, 3)[idx])

    def full(x: Tensor) -> Tensor:
        out = torch.zeros((active.numel(),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        out[idx] = x
        return out.reshape(active.shape + tuple(x.shape[1:]))

    return Hit(*(full(x) for x in h))


def trace_paths(hit_fn: HitFn, o: Tensor, d: Tensor, pixel_id: Tensor, sample_id, seed: int,
                max_bounces: int, sky: str) -> tuple[Tensor, Tensor]:
    """(radiance [..., 3], traced segments int64): every active ray of every
    bounce is one segment; a path ends at a miss, an absorbing metal or
    the bounce cap, where it gathers no more light."""
    throughput = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    active = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    rays = torch.zeros((), dtype=torch.int64, device=o.device)
    for b in range(max_bounces):
        if b and not bool(active.any()):
            break
        h = _trace_active(hit_fn, o, d, active)
        u = uniform4(pixel_id, sample_id, b, seed & MASK, o.dtype)
        direction, attenuation, absorbed = scatter(h, d, u)
        missed = active & ~h.hit
        hit_active = active & h.hit
        radiance = radiance + torch.where(missed[..., None], throughput * sky_color(d, sky), 0.0)
        t_safe = torch.where(h.hit, h.t, torch.ones_like(h.t))
        p_hit = o + t_safe[..., None] * d
        throughput = torch.where(hit_active[..., None], throughput * attenuation, throughput)
        rays = rays + active.sum(dtype=torch.int64)
        active = hit_active & ~absorbed
        o = torch.where(hit_active[..., None], p_hit, o)
        d = torch.where(hit_active[..., None], direction, d)
    return radiance, rays


def render_rows(hit_fn: HitFn, camera: Camera, width: int, height: int, rows, spp: int,
                max_bounces: int, seed: int, sky: str, lens: bool, sample_offset: int,
                sample_batch: int = 1) -> tuple[Tensor, Tensor]:
    """The mean radiance [len(rows), width, 3] of the frame's ``rows`` (any
    row indices, in the order given) and their traced segments. Every
    counter is a function of global pixel coordinates, so a row renders as
    it does in the whole frame. Samples are summed one after another,
    ``sample_batch`` of them traced together."""
    dev = camera.origin.device
    dtype = camera.origin.dtype
    ys = torch.as_tensor(rows, dtype=torch.int64, device=dev).reshape(-1, 1)
    xs = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    pixel_id = ys * width + xs
    acc = torch.zeros((ys.shape[0], width, 3), dtype=dtype, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for first in range(0, spp, sample_batch):
        n = min(sample_batch, spp - first)
        s = (torch.arange(first, first + n, dtype=torch.int64, device=dev)
             + int(sample_offset)) & MASK
        s = int(s[0]) if n == 1 else s[:, None, None]
        u = uniform4(pixel_id, s, JITTER_KEY, seed, dtype)
        st_x, st_y = pixel_st(xs, ys, u[..., 0], u[..., 1], width, height)
        lens_uv = None
        if lens:
            r = torch.sqrt(u[..., 2])
            phi = (2.0 * math.pi) * u[..., 3]
            lens_uv = torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
        o, d = camera.rays(st_x, st_y, lens_uv)
        radiance, r_count = trace_paths(hit_fn, o, d, pixel_id, s, seed, max_bounces, sky)
        for one in (radiance,) if n == 1 else radiance.unbind(0):
            acc = acc + one
        rays = rays + r_count
    return acc / spp, rays


def tonemap_u8(linear: Tensor, gamma: float = 2.0) -> Tensor:
    """Clamp to [0, 1], gamma 2 (a square root), quantise to uint8."""
    x = torch.clamp(linear, 0.0, 1.0)
    x = torch.sqrt(x) if gamma == 2.0 else x ** (1.0 / gamma)
    return torch.clamp(x * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
