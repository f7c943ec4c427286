"""The config4 golden (tools/make_goldens.py: the RTIOW final scene,
160x90, 4 spp, 8 bounces, lens with aperture 0.1, seed 4) through the
port's ``PathTraceRenderer`` on the CPU (ROADMAP C-5).

The golden is the JAX reference path under XLA's jit, and only that
arithmetic reproduces it: run op by op (``jax.disable_jit()``) the JAX
reference itself misses it at RMSE 5.4e-3. The port misses it at 6.2e-3,
and the divergence is found:

- XLA's CPU dot (the cross terms d.c and o.c of ``spheres_nearest_hit``)
  is a chain of fused multiply-adds, where the port, the JAX package's
  Pallas kernel and the CUDA kernel (built with -fmad=false) round every
  product and sum; that moves a sphere's t by an ulp or two, which flips
  silhouette paths among the lattice's 480 small spheres;
- torch's float32 ``sqrt`` on the CPU was not correctly rounded in the
  port's quadratic (now ``vec.sqrt``, as XLA and CUDA round);
- what remains is torch's and XLA's float32 ``cos``/``sin`` (the lens and
  Lambertian samples), which differ in the last bit for about 5% of
  arguments.

So the bound pinned here is the port's own distance, beside two witnesses:
JAX run op by op misses the golden by as much, and JAX run op by op with
the kernels' float grouping (each product rounded) renders the port's
image but for a few pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from csgrenderer_tpu.app.renderers import PathTraceRenderer as JPathTraceRenderer
from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.math import vec as jvec
from csgrenderer_tpu.models import rtiow_final_scene as j_rtiow
from csgrenderer_tpu.render import integrator as jintegrator
from csgrenderer_tpu.render import intersect as jintersect
from csgrenderer_tpu.render import tonemap as jtonemap
from csgrenderer_tpu.utils.config import RenderConfig as JRenderConfig
from csgrenderer_tpu_torch.app.goldens import golden_renderers
from csgrenderer_tpu_torch.io import read_png, rmse

from test_torch_app import GOLDENS


def _edot(v, w):
    return v[..., 0] * w[..., 0] + v[..., 1] * w[..., 1] + v[..., 2] * w[..., 2]


def _kernel_grouping_hit(scene):
    """JAX's SphereScene.nearest_hit with every dot product written out
    (each product rounded, summed left to right), as the port and the
    kernels form them."""

    def hit(o, d, eps=1e-3):
        fo, fd = o.reshape(-1, 3), d.reshape(-1, 3)
        c = scene.centers[None]
        dc, oc = _edot(fd[:, None, :], c), _edot(fo[:, None, :], c)
        od, oo, a = _edot(fo, fd)[:, None], _edot(fo, fo)[:, None], _edot(fd, fd)[:, None]
        half_b = od - dc
        c_term = oo - 2.0 * oc + _edot(scene.centers, scene.centers) - scene.radii * scene.radii
        disc = half_b * half_b - a * c_term
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        inv_a = 1.0 / a
        t0, t1 = (-half_b - sq) * inv_a, (-half_b + sq) * inv_a
        t = jnp.where(t0 > eps, t0, t1)
        t = jnp.where((disc > 0.0) & (t > eps) & (t < jintersect.T_FAR), t, jintersect.T_FAR)
        idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
        t_near = jnp.min(t, axis=-1)
        hit = t_near < jintersect.T_FAR
        p = fo + jnp.where(hit, t_near, 1.0)[:, None] * fd
        outward = (p - scene.centers[idx]) / scene.radii[idx][:, None]
        front = jvec.dot(fd, outward) < 0.0
        n = jnp.where(front[:, None], outward, -outward)
        b = o.shape[:-1]
        return jintegrator.SurfaceHit(
            t=t_near.reshape(b), hit=hit.reshape(b), normal=n.reshape(b + (3,)),
            front_face=front.reshape(b), mat_kind=scene.mat_kind[idx].reshape(b),
            albedo=scene.albedo[idx].reshape(b + (3,)), mat_param=scene.mat_param[idx].reshape(b))

    return hit


def test_config4_golden_pinned_beside_jax_op_by_op():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r, t_sec = golden_renderers("cpu")["config4_rtiow_final"]()
        img = r.draw_frame(t_sec).numpy()
    finally:
        torch.set_num_threads(threads)
    golden = read_png(GOLDENS / "config4_rtiow_final.png")
    assert img.shape == golden.shape == (90, 160, 3)
    assert rmse(img, golden) <= 6.3e-3  # 6.22e-3

    cam = JCamera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=160 / 90,
                          aperture=0.1, focus_dist=10.0)
    cfg = JRenderConfig(width=160, height=90, spp=4, max_bounces=8, seed=4, lens=True)
    scene = j_rtiow()
    with jax.disable_jit():
        op_by_op = np.asarray(JPathTraceRenderer(scene, cam, cfg, backend="jnp").draw_frame(0.0))
        lin, _ = jintegrator.render_image(_kernel_grouping_hit(scene), cam, 160, 90, spp=4,
                                          max_bounces=8, seed=4, lens=True)
        grouped = np.asarray(jtonemap.to_uint8(jtonemap.tonemap(lin, gamma=2.0)))
    assert rmse(op_by_op, golden) >= 5e-3  # 5.43e-3: the golden needs XLA's fused arithmetic
    assert rmse(grouped, golden) >= 5e-3  # 6.18e-3
    off = (np.abs(img.astype(int) - grouped.astype(int)).max(axis=-1) > 0).sum()
    assert off <= 10  # 9 pixels: torch's and XLA's cos/sin
