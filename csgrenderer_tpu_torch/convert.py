"""Carry state from the JAX package into this one.

The JAX package's scenes, CSG tapes, cameras and lamp tables are pytrees
of arrays;
handed over as numpy arrays (``np.asarray(field)``) and plain tuples,
these functions rebuild them as this package's containers, so both
packages render the identical scene through the identical camera. Nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera.pinhole import Camera
from .render.integrator import SphereScene
from .render.lights import SphereLights, TriLights
from .scene.tape import CompiledTape


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(device)


def sphere_scene_from_numpy(centers, radii, mat_kind, albedo, mat_param, device=None) -> SphereScene:
    """SphereScene from the five per-sphere arrays ([S,3], [S], [S], [S,3], [S])."""
    kind = torch.from_numpy(np.array(mat_kind, dtype=np.int32, copy=True)).to(device)
    scene = SphereScene(
        centers=_f32(centers, device),
        radii=_f32(radii, device),
        mat_kind=kind,
        albedo=_f32(albedo, device),
        mat_param=_f32(mat_param, device),
    )
    s = scene.num_spheres
    shapes = [tuple(x.shape) for x in (scene.centers, scene.radii, kind, scene.albedo, scene.mat_param)]
    if shapes != [(s, 3), (s,), (s,), (s, 3), (s,)]:
        raise ValueError(f"inconsistent sphere arrays: {shapes}")
    return scene


def camera_from_numpy(origin, lower_left, horizontal, vertical, u, v, lens_radius, device=None) -> Camera:
    """Camera from the JAX ``Camera`` fields (six [3] vectors and a scalar)."""
    return Camera(
        origin=_f32(origin, device),
        lower_left=_f32(lower_left, device),
        horizontal=_f32(horizontal, device),
        vertical=_f32(vertical, device),
        u=_f32(u, device),
        v=_f32(v, device),
        lens_radius=_f32(lens_radius, device).reshape(()),
    )


def tape_from_numpy(ops, leaf_types, leaf_chains, k, stack_depth, leaf_params, edge_quat,
                    edge_off, leaf_rot, leaf_pos, mat_kind, albedo, mat_param,
                    device=None) -> CompiledTape:
    """CompiledTape from a JAX tape's static tuples and its eight arrays,
    taken as they are (the baked transforms are not recomputed)."""
    n, e = len(leaf_types), len(edge_quat)
    tape = CompiledTape(
        ops=ops, leaf_types=leaf_types, leaf_chains=leaf_chains, k=k, stack_depth=stack_depth,
        leaf_params=_f32(leaf_params, device).reshape(n, 4),
        edge_quat=_f32(edge_quat, device).reshape(e, 4),
        edge_off=_f32(edge_off, device).reshape(e, 3),
        leaf_rot=_f32(leaf_rot, device).reshape(n, 4),
        leaf_pos=_f32(leaf_pos, device).reshape(n, 3),
        mat_kind=torch.from_numpy(np.array(mat_kind, dtype=np.int32, copy=True)).to(device),
        albedo=_f32(albedo, device).reshape(n, 3),
        mat_param=_f32(mat_param, device),
    )
    if tuple(tape.mat_kind.shape) != (n,) or tuple(tape.mat_param.shape) != (n,):
        raise ValueError("inconsistent tape arrays")
    return tape


def lights_from_numpy(*fields, device=None) -> SphereLights | TriLights:
    """SphereLights from (centers [L,3], radii [L], emit [L,3]), or
    TriLights from (v0, e1, e2, emit, normal [L,3] each, area [L]): a JAX
    lamp table's fields in its own order."""
    kind = {3: SphereLights, 6: TriLights}.get(len(fields))
    if kind is None:
        raise ValueError(f"expected 3 (sphere) or 6 (triangle) lamp arrays, got {len(fields)}")
    lights = kind(*(_f32(f, device) for f in fields))
    n = lights.num_lights
    shapes = [tuple(t.shape) for t in lights]
    want = [(n,) if name in ("radii", "area") else (n, 3) for name in kind._fields]
    if shapes != want:
        raise ValueError(f"inconsistent lamp arrays: {shapes}")
    return lights
