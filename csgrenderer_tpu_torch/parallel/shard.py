"""Multi-device rendering over the ("tile", "sample") rank mesh.

Twin of ``csgrenderer_tpu/parallel/shard.py``. Where JAX runs one program
over the mesh (``shard_map``), every rank here runs its own share:

- the image's ROW dimension is sharded over "tile": rank (i, j) renders the
  full-width slab of rows [i * H / tile, (i + 1) * H / tile) and returns it
  (what JAX's row-sharded output holds on that device); ``gather_rows``
  assembles the frame for a caller that needs it;
- SAMPLES per pixel are sharded over "sample": rank (i, j) renders
  ``spp / sample`` samples from ``sample_offset + j * spp / sample``, and
  one all-reduce over its sample group sums the radiance; the ray counts
  sum, in int64, over the whole mesh.

The RNG is counter-based per global (pixel, sample) and the kernels add
the slab's row offset before the pixel id, the camera sample and the RNG
keys, so a mesh with one sample way returns the single-device image bit
for bit; with more, only the order of the sample sum changes.

Collectives: under gloo a CUDA tensor is copied to the host around every
collective here (``all_reduce``, ``all_gather``); the kernels still run on
the card. Gloo stages CUDA tensors through the host in any case, and the
explicit copy keeps the path independent of which gloo operations take
CUDA tensors in a given torch build. NCCL takes them as they are.

JAX's ``shard_map`` needs ``check_vma=False`` around the Pallas kernels
(its varying-axes checker cannot type them; tests/test_parallel.py keeps
a canary for it). ``torch.distributed`` has no such checker: each rank
launches its kernels as a single-device caller does, so this package
needs no escape hatch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..io.checkpoint import Accumulator
from ..kernels import megakernel, tape_kernel, trimesh_kernel
from ..render import integrator
from ..render.integrator import SphereScene
from ..render.tonemap import tonemap
from ..render.trimesh import MeshScene
from ..scene.tape import CompiledTape
from .mesh import RankMesh, render_device

_PACKED = (megakernel.PackedScene, tape_kernel.PackedTape, trimesh_kernel.PackedMesh)


def _host_staged(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective over ``group`` takes: a host copy of a CUDA
    tensor under gloo, else ``t`` itself (contiguous)."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return t.detach().cpu()
    return t.contiguous()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (``t`` itself where the group is None,
    a mesh axis of one rank), on ``t``'s device."""
    if group is None:
        return t
    buf = _host_staged(t, group)
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def gather_rows(slab: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """The whole frame [H, ...] from every tile's row slab [H / tile, ...]
    (an all-gather over this rank's tile group, in tile order), on the
    slab's device. Every rank of the mesh must call it."""
    if mesh.tile_group is None:
        return slab
    buf = _host_staged(slab, mesh.tile_group)
    parts = [torch.empty_like(buf) for _ in range(mesh.tile_ways)]
    dist.all_gather(parts, buf, group=mesh.tile_group)
    return torch.cat(parts).to(slab.device)


def _shard(mesh: RankMesh, height: int, spp: int) -> tuple[int, int, int, int]:
    """(rows, samples, first row, first sample offset) of this rank."""
    tile_ways, sample_ways = mesh.tile_ways, mesh.sample_ways
    if height % tile_ways:
        raise ValueError(f"height {height} not divisible by tile axis {tile_ways}")
    if spp % sample_ways:
        raise ValueError(f"spp {spp} not divisible by sample axis {sample_ways}")
    rows_local, spp_local = height // tile_ways, spp // sample_ways
    tile_index, sample_index = mesh.index
    return rows_local, spp_local, tile_index * rows_local, sample_index * spp_local


def render_image_sharded(
    hit_fn,
    camera,
    width: int,
    height: int,
    mesh: RankMesh,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    jitter: bool = True,
    lens: bool = False,
    sample_offset: int = 0,
):
    """Sharded equivalent of ``integrator.render_image`` (the plain path).

    Returns (this rank's row slab [H / tile, W, 3], the sum over the
    sample group divided by ``spp``; the mesh's total rays, an int64
    scalar). Requires ``height`` divisible by the tile ways and ``spp`` by
    the sample ways.
    """
    rows_local, spp_local, y0, s0 = _shard(mesh, height, spp)
    radiance_sum, rays = integrator.render_tile(
        hit_fn, camera, width, height, 0, y0, width, rows_local, spp=spp_local,
        max_bounces=max_bounces, seed=seed, sky=sky, jitter=jitter, lens=lens,
        sample_offset=sample_offset + s0,
    )
    radiance_sum = _all_reduce(radiance_sum, mesh.sample_group)
    return radiance_sum / spp, _all_reduce(rays, mesh.group)


def _pack(scene, device, worklist):
    """The scene packed for its kernel wrapper on ``device`` (as the wrapper
    would pack it)."""
    if isinstance(scene, _PACKED):
        if worklist != "auto":
            raise ValueError("worklist is fixed when the scene is already packed")
        return scene.to(device)
    if isinstance(scene, SphereScene):
        return megakernel.pack_scene(scene.to(device), worklist)
    if isinstance(scene, CompiledTape):
        return tape_kernel.pack_program(scene.to(device))
    if isinstance(scene, MeshScene):
        return trimesh_kernel.pack_mesh(scene.to(device), worklist)
    raise TypeError(f"unsupported scene type {type(scene)}")


def render_scene_sharded(
    scene,
    camera,
    width: int,
    height: int,
    mesh: RankMesh,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    lens: bool = False,
    sample_offset: int = 0,
    device=None,
    nee: bool = False,
    worklist: bool | str = "auto",
    gather_pages: int = 4,
):
    """Scene-level sharded render: the hand kernels on each rank's row slab
    x sample shard.

    The production multi-device path: each rank runs the kernel wrapper of
    its scene type (``render_image_kernel`` for a ``SphereScene``,
    ``render_image_tape_kernel`` for a ``CompiledTape``,
    ``render_image_mesh_kernel`` for a ``MeshScene``, or their packed
    forms) with ``rows``/``row_offset`` of its slab and its sample range;
    the radiance times the rank's samples sums over the sample group and
    is divided by ``spp`` (JAX's arithmetic, exact for a power-of-two
    ``spp``; a mesh with one sample way returns the kernel's image as it
    is), and the rays sum over the mesh. Returns (this rank's slab
    [H / tile, W, 3], total rays as an int64 scalar).

    ``device`` (default: the mesh's) replaces JAX's ``backend=`` and
    ``interpret=``: "cuda" launches the kernels; "cpu" runs their plain
    versions, the counterpart of JAX's interpret mode, NEE included. JAX's
    ``backend="jnp"`` route is ``render_image_sharded`` with the scene's
    ``nearest_hit``. ``nee``: next-event estimation toward the scene's
    lamps. ``worklist`` goes to the sphere and mesh packers (the mesh grid
    serves the meshes of JAX's stream and HBM modes). ``gather_pages`` is a
    knob of JAX's TPU stream gather: accepted and ignored.
    """
    del gather_pages  # the TPU stream gather's page count: no counterpart here
    if nee and not isinstance(scene, (SphereScene, CompiledTape, MeshScene, *_PACKED)):
        raise NotImplementedError(
            "nee is for emissive SphereScenes, CompiledTapes, or MeshScenes"
        )
    rows_local, spp_local, y0, s0 = _shard(mesh, height, spp)
    dev = mesh.device if device is None else render_device(device)
    packed = _pack(scene, dev, worklist)
    kw = dict(spp=spp_local, max_bounces=max_bounces, seed=seed, sky=sky, lens=lens,
              sample_offset=sample_offset + s0, rows=rows_local, row_offset=y0, nee=nee)
    if isinstance(packed, megakernel.PackedScene):
        radiance, rays = megakernel.render_image_kernel(packed, camera.to(dev), width, height, **kw)
    elif isinstance(packed, tape_kernel.PackedTape):
        radiance, rays = tape_kernel.render_image_tape_kernel(packed, camera.to(dev), width,
                                                              height, **kw)
    else:
        radiance, rays = trimesh_kernel.render_image_mesh_kernel(packed, camera.to(dev), width,
                                                                 height, **kw)
    if mesh.sample_group is not None:
        radiance = _all_reduce(radiance * spp_local, mesh.sample_group) / spp
    return radiance, _all_reduce(rays, mesh.group)


def _frame_noise(acc_a: Accumulator, acc_b: Accumulator, mesh: RankMesh, height: int,
                 width: int) -> float:
    """rmse(tonemap(A), tonemap(B)) / 2 on gamma-2 floats over the whole
    frame. Each rank's slab gives its float64 sum of squares; every rank
    gathers all of them and adds sample index 0's in tile order, so every
    rank holds the same float and takes the same stop decision."""
    a, b = (tonemap(acc.image(), gamma=2.0).cpu().numpy().astype(np.float64)
            for acc in (acc_a, acc_b))
    mine = torch.tensor([float(np.sum((a - b) ** 2))], dtype=torch.float64)
    if mesh.group is None:
        sums = [mine]
    else:
        sums = [torch.empty_like(mine) for _ in mesh.ranks]
        dist.all_gather(sums, mine, group=mesh.group)
    total = 0.0
    for s in sums[::mesh.sample_ways]:  # mesh positions (i, 0), i = 0 .. tile - 1
        total += float(s[0])
    return math.sqrt(total / (height * width * 3)) / 2.0


def render_to_noise_sharded(
    scene,
    camera,
    width: int,
    height: int,
    mesh: RankMesh,
    target: float = 1e-3,
    max_spp: int = 1 << 16,
    spp_chunk: int = 16,
    sample_offset: int = 0,
    device=None,
    worklist: bool | str = "auto",
    **render_kwargs,
):
    """Multi-device render-to-quality: the two-stream noise certificate of
    ``PathTraceRenderer.render_to_noise`` (app/renderers.py) over the
    production sharded path.

    Accumulates ``spp_chunk``-sized ``render_scene_sharded`` calls into two
    independent half-streams over this rank's slab, from disjoint
    ``sample_offset`` ranges, and checks the certificate rmse(tonemap(A),
    tonemap(B)) / 2 on gamma-2 floats over the whole frame at powers of two
    of the pair count. Every rank computes the same noise from the same
    gathered sums (``_frame_noise``), so all leave the loop together: a
    rank that left early would leave the others waiting in a collective.

    Returns ``(accumulator of this rank's slab, noise, spp_used)``; the
    accumulator's ``rays_traced`` counts the whole mesh's rays.
    ``render_kwargs`` go to ``render_scene_sharded`` (nee, sky, lens,
    seed, max_bounces, gather_pages); the scene is packed once, with
    ``worklist``, on ``device`` (default: the mesh's).
    """
    dev = mesh.device if device is None else render_device(device)
    packed = _pack(scene, dev, worklist)
    camera = camera.to(dev)
    rows_local = _shard(mesh, height, spp_chunk)[0]
    acc = [Accumulator.zeros(rows_local, width, dev) for _ in range(2)]
    offset = int(sample_offset)
    noise = float("inf")
    pairs = 0
    next_check = 1
    while 2 * pairs * spp_chunk < max_spp:
        for which in range(2):
            radiance, rays = render_scene_sharded(
                packed, camera, width, height, mesh, spp=spp_chunk, sample_offset=offset,
                device=dev, **render_kwargs,
            )
            acc[which] = acc[which].add(radiance * spp_chunk, spp_chunk, rays)
            offset += spp_chunk
        pairs += 1
        if pairs >= next_check:
            next_check *= 2
            noise = _frame_noise(acc[0], acc[1], mesh, height, width)
            if noise <= target:
                break
    merged = Accumulator(
        radiance_sum=acc[0].radiance_sum + acc[1].radiance_sum,
        sample_count=acc[0].sample_count + acc[1].sample_count,
        rays_traced=acc[0].rays_traced + acc[1].rays_traced,
    )
    return merged, noise, 2 * pairs * spp_chunk
