"""Per-cell sphere worklists: the grid packer and the plain-torch grid walk.

Twin of ``csgrenderer_tpu/kernels/worklist.py``. Small spheres confined to
a thin y-slab are binned into a Cx x Cz grid over xz (circle-rectangle
overlap, so every cell lists EVERY sphere whose surface can appear inside
it). Oversized or outlier spheres stay "global" and are brute-forced for
every segment (the ground and the hero spheres of the RTIOW scene). Cells
that overflow the m slots spill their widest spheres to the globals.

``pack_grid`` makes the same cell choice, binning, spill rule and
globals-first reorder as the JAX packer, but stores what a GPU reads
directly: the reordered scene in exact f32 and an ``[n_cells, m]`` int32
table of sphere ids padded with -1. (The JAX packer's bf16 hi/lo split
served the TPU's one-hot matmul gather; a GPU does a plain indexed load.)

``grid_nearest_hit`` is the batched 2D DDA of the JAX ``grid_setup`` /
``grid_step``: the plain version of the CUDA kernel's traversal. A walk
stops when its best hit precedes the next cell (cells are visited in
increasing t, so any nearer hit was already found), when it leaves the
grid or slab, or when it passes the globals' best hit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..math import vec
from ..render.integrator import SphereScene
from ..render.intersect import T_FAR, quadratic_t, ray_terms

BIG = 1e30
BIG_CUT = 5e29
EPS_FLAT = 1e-12  # |d| along an axis below this counts as parallel to it

# the JAX packer's defaults
M_SLOTS = 8  # worklist slots per cell
MAX_CELLS = 32 * 32
MIN_GRID_SPHERES = 48  # fewer small spheres than this: no grid
RADIUS_FACTOR = 4.0  # "small" = radius <= RADIUS_FACTOR x median radius


class GridStatic(NamedTuple):
    """Grid geometry (same fields and values as the JAX GridStatic, less
    its TPU lane padding ``c_pad``)."""

    cx: int  # cells along x
    cz: int  # cells along z
    m: int  # worklist slots per cell
    x0: float
    z0: float
    cell: float  # cell edge length (square cells)
    y_lo: float
    y_hi: float

    def f32_params(self) -> dict:
        """The DDA's float constants, rounded to f32 as the JAX kernel
        rounds them (bounds computed in f64 first)."""
        return dict(
            x0=np.float32(self.x0),
            z0=np.float32(self.z0),
            x1=np.float32(self.x0 + self.cx * self.cell),
            z1=np.float32(self.z0 + self.cz * self.cell),
            y_lo=np.float32(self.y_lo),
            y_hi=np.float32(self.y_hi),
            cell=np.float32(self.cell),
            inv_cell=np.float32(1.0 / self.cell),
        )

    @property
    def max_steps(self) -> int:
        """A 2D DDA visits at most cx + cz - 1 cells; a walk is capped here."""
        return self.cx + self.cz


@dataclass(frozen=True)
class GridPack:
    static: GridStatic
    cell_ids: Tensor  # [cx*cz, m] int32, reordered sphere ids, -1 = empty
    order: np.ndarray  # permutation: new index -> original sphere index
    n_globals: int  # globals occupy reordered indices [0, n_globals)

    def to(self, device) -> "GridPack":
        return GridPack(self.static, self.cell_ids.to(device), self.order, self.n_globals)


def _overlap_lists(cgrid, rgrid, x0, z0, cell, ncx, ncz):
    """Per-cell candidate lists via circle-rectangle overlap (numpy)."""
    lists: list[list[int]] = [[] for _ in range(ncx * ncz)]
    for i in range(cgrid.shape[0]):
        cx_, cz_, r = cgrid[i, 0], cgrid[i, 2], rgrid[i]
        ix0 = max(0, int(np.floor((cx_ - r - x0) / cell)))
        ix1 = min(ncx - 1, int(np.floor((cx_ + r - x0) / cell)))
        iz0 = max(0, int(np.floor((cz_ - r - z0) / cell)))
        iz1 = min(ncz - 1, int(np.floor((cz_ + r - z0) / cell)))
        for ix in range(ix0, ix1 + 1):
            # nearest point of the cell's x-range to the center
            nx = np.clip(cx_, x0 + ix * cell, x0 + (ix + 1) * cell)
            for iz in range(iz0, iz1 + 1):
                nz = np.clip(cz_, z0 + iz * cell, z0 + (iz + 1) * cell)
                if (nx - cx_) ** 2 + (nz - cz_) ** 2 <= r * r + 1e-12:
                    lists[ix * ncz + iz].append(i)
    return lists


def pack_grid(scene: SphereScene) -> tuple[GridPack, SphereScene] | None:
    """(GridPack, scene reordered globals-first), or None if a grid won't help.

    Small spheres (radius <= RADIUS_FACTOR x median radius) that fit a thin
    y-slab go into the grid; everything else stays global. The tensors
    returned live on the scene's device.
    """
    c = scene.centers.detach().cpu().numpy().astype(np.float64)
    r = np.abs(scene.radii.detach().cpu().numpy().astype(np.float64))
    s = c.shape[0]
    m = M_SLOTS
    if s < MIN_GRID_SPHERES:
        return None

    med = float(np.median(r))
    small = r <= RADIUS_FACTOR * med
    if int(small.sum()) < MIN_GRID_SPHERES:
        return None

    # the slab must be thin relative to the xz extent, else a 2D grid is
    # the wrong spatial structure for this scene
    y_lo = float(np.min(c[small, 1] - r[small]))
    y_hi = float(np.max(c[small, 1] + r[small]))
    ex_x = float(np.max(c[small, 0] + r[small]) - np.min(c[small, 0] - r[small]))
    ex_z = float(np.max(c[small, 2] + r[small]) - np.min(c[small, 2] - r[small]))
    if (y_hi - y_lo) > 0.5 * max(ex_x, ex_z):
        return None

    x0 = float(np.min(c[small, 0] - r[small]))
    x1 = float(np.max(c[small, 0] + r[small]))
    z0 = float(np.min(c[small, 2] - r[small]))
    z1 = float(np.max(c[small, 2] + r[small]))

    idx_small = np.where(small)[0]
    cgrid = c[idx_small]
    rgrid = r[idx_small]

    # the LARGEST cell whose worst cell still fits m slots; spill overfull
    # cells' widest spheres to globals if even the densest grid can't fit
    best = None
    best_candidate = None
    target = max(ex_x, ex_z)
    for n_side in (6, 7, 8, 9, 10, 11, 12, 14, 16, 20, 24, 28, 32):
        cell = target / n_side + 1e-9
        ncx = max(1, int(np.ceil((x1 - x0) / cell)))
        ncz = max(1, int(np.ceil((z1 - z0) / cell)))
        if ncx * ncz > MAX_CELLS:
            break
        lists = _overlap_lists(cgrid, rgrid, x0, z0, cell, ncx, ncz)
        worst = max((len(l) for l in lists), default=0)
        if worst <= m:
            best = (cell, ncx, ncz, lists, [])
            break
        best_candidate = (cell, ncx, ncz, lists)
    if best is None:
        if best_candidate is None:
            return None
        cell, ncx, ncz, lists = best_candidate
        spilled: set[int] = set()
        changed = True
        while changed:
            changed = False
            for l in lists:
                live = [i for i in l if i not in spilled]
                if len(live) > m:
                    live_sorted = sorted(live, key=lambda i: -rgrid[i])
                    for i in live_sorted[: len(live) - m]:
                        spilled.add(i)
                    changed = True
        lists = [[i for i in l if i not in spilled] for l in lists]
        best = (cell, ncx, ncz, lists, sorted(spilled))
        if len(spilled) > 0.25 * len(idx_small):
            return None

    cell, ncx, ncz, lists, spilled_local = best
    spilled_set = set(spilled_local)
    grid_local = [i for i in range(len(idx_small)) if i not in spilled_set]
    grid_orig = idx_small[grid_local]
    global_orig = np.setdiff1d(np.arange(s), grid_orig)

    order = np.concatenate([global_orig, grid_orig])
    inv = np.empty(s, np.int64)
    inv[order] = np.arange(s)

    cell_ids = np.full((ncx * ncz, m), -1, np.int32)
    for cell_i, l in enumerate(lists):
        live = [i for i in l if i not in spilled_set]
        assert len(live) <= m
        cell_ids[cell_i, : len(live)] = inv[idx_small[live]]

    dev = scene.device
    perm = torch.from_numpy(order).to(dev)
    reordered = SphereScene(
        centers=scene.centers[perm],
        radii=scene.radii[perm],
        mat_kind=scene.mat_kind[perm],
        albedo=scene.albedo[perm],
        mat_param=scene.mat_param[perm],
    )
    static = GridStatic(
        cx=ncx, cz=ncz, m=m, x0=x0, z0=z0, cell=float(cell), y_lo=y_lo, y_hi=y_hi
    )
    pack = GridPack(
        static=static,
        cell_ids=torch.from_numpy(cell_ids).to(dev),
        order=order,
        n_globals=len(global_orig),
    )
    return pack, reordered


def _axis_range(o_c, d_c, inv, lo, hi):
    t0 = (lo - o_c) * inv
    t1 = (hi - o_c) * inv
    lo_t = torch.minimum(t0, t1)
    hi_t = torch.maximum(t0, t1)
    # |d| ~ 0: inside -> (-BIG, BIG), outside -> empty
    flat = torch.abs(d_c) < EPS_FLAT
    inside = (o_c >= lo) & (o_c <= hi)
    big = torch.full_like(lo_t, BIG)
    lo_t = torch.where(flat, torch.where(inside, -big, big), lo_t)
    hi_t = torch.where(flat, torch.where(inside, big, -big), hi_t)
    return lo_t, hi_t


def add_count(counts: dict, key: str, value) -> None:
    """Adds ``value`` (an int or an int64 tensor) to ``counts[key]``. The
    walks call it under ``if counts is not None``, so a walk that counts
    nothing does no counting work."""
    counts[key] = counts.get(key, 0) + value


def grid_nearest_hit(
    pack: GridPack, scene: SphereScene, o: Tensor, d: Tensor, eps: float = 1e-3,
    counts: dict | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Nearest hit of flat rays [N,3] through globals + grid worklists.

    ``scene`` is the reordered scene ``pack_grid`` returned. Returns
    (t [N] (BIG on a miss), idx [N] int64 reordered sphere id, hit [N]).

    ``counts``: a dict to which the work is added (ints, or int64 tensors
    where it is a reduction on the device), as the kernel's grid mode
    executes it for these rays: the globals' sphere tests
    (``global_tests``), the rays that enter the grid (``walks``), the cells
    visited (``cell_visits``) and the walk's sphere tests (``sphere_tests``,
    the filled slots of each visited cell).
    """
    gs = pack.static
    f = {k: float(v) for k, v in gs.f32_params().items()}
    cc_all = vec.dot(scene.centers, scene.centers)
    r2_all = scene.radii * scene.radii
    od, oo, a, inv_a = ray_terms(o, d)

    def sphere_t(ids: Tensor, lanes=slice(None)) -> Tensor:
        """t [n, k] of rays ``lanes`` against sphere ids [n or 1, k]."""
        c = scene.centers[ids]
        return quadratic_t(
            od[lanes], oo[lanes], a[lanes], inv_a[lanes],
            vec.dot(d[lanes][:, None, :], c), vec.dot(o[lanes][:, None, :], c),
            cc_all[ids], r2_all[ids], eps, T_FAR, BIG,
        )

    # globals: brute force, lowest id first on equal t
    g = pack.n_globals
    if g:
        tg = sphere_t(torch.arange(g, device=o.device)[None, :])
        id_best = torch.argmin(tg, dim=1)
        t_best = torch.gather(tg, 1, id_best[:, None])[:, 0]
    else:
        t_best = torch.full_like(a[:, 0], BIG)
        id_best = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    if counts is not None:
        add_count(counts, "global_tests", o.shape[0] * g)

    # DDA setup (JAX worklist.grid_setup)
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    inv_dx, inv_dy, inv_dz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    tx_lo, tx_hi = _axis_range(ox, dx, inv_dx, f["x0"], f["x1"])
    ty_lo, ty_hi = _axis_range(oy, dy, inv_dy, f["y_lo"], f["y_hi"])
    tz_lo, tz_hi = _axis_range(oz, dz, inv_dz, f["z0"], f["z1"])
    t_in = torch.maximum(torch.maximum(tx_lo, ty_lo), torch.clamp(tz_lo, min=1e-3))
    t_out = torch.minimum(torch.minimum(tx_hi, ty_hi), tz_hi)
    t_out = torch.minimum(t_out, t_best)
    march = t_in <= t_out

    px = ox + t_in * dx
    pz = oz + t_in * dz
    # clamp in float first: the far-off points of lanes that do not
    # march must not overflow the integer cast
    ix = torch.clamp(torch.floor((px - f["x0"]) * f["inv_cell"]), 0, gs.cx - 1).to(torch.int64)
    iz = torch.clamp(torch.floor((pz - f["z0"]) * f["inv_cell"]), 0, gs.cz - 1).to(torch.int64)
    step_x = torch.sign(dx).to(torch.int64)
    step_z = torch.sign(dz).to(torch.int64)
    flat_x = torch.abs(dx) < EPS_FLAT
    flat_z = torch.abs(dz) < EPS_FLAT
    big = torch.full_like(dx, BIG)
    next_bx = f["x0"] + (ix + (step_x > 0).to(torch.int64)).to(torch.float32) * f["cell"]
    next_bz = f["z0"] + (iz + (step_z > 0).to(torch.int64)).to(torch.float32) * f["cell"]
    tmaxx = torch.where(flat_x, big, (next_bx - ox) * inv_dx)
    tmaxz = torch.where(flat_z, big, (next_bz - oz) * inv_dz)
    tdx = torch.where(flat_x, big, torch.abs(f["cell"] * inv_dx))
    tdz = torch.where(flat_z, big, torch.abs(f["cell"] * inv_dz))

    # the walk runs on the marching lanes only (the kernel's threads each
    # walk alone); state arrays below are indexed like ``lane``
    cell_ids = pack.cell_ids.to(torch.int64)
    lane = torch.nonzero(march)[:, 0]
    if counts is not None:
        add_count(counts, "walks", lane.numel())
    ix, iz, tmaxx, tmaxz = ix[lane], iz[lane], tmaxx[lane], tmaxz[lane]
    tdx, tdz, step_x, step_z = tdx[lane], tdz[lane], step_x[lane], step_z[lane]
    t_out, t_b, id_b = t_out[lane], t_best[lane], id_best[lane]
    for _ in range(gs.max_steps):
        if lane.numel() == 0:
            break
        # one DDA step (JAX worklist.grid_step)
        ids = cell_ids[ix * gs.cz + iz]  # [n, m]
        if counts is not None:
            add_count(counts, "cell_visits", lane.numel())
            add_count(counts, "sphere_tests", (ids >= 0).sum(dtype=torch.int64))
        tc = sphere_t(torch.clamp(ids, min=0), lane)
        tc = torch.where(ids >= 0, tc, torch.full_like(tc, BIG))
        j = torch.argmin(tc, dim=1)  # first slot = lowest id on equal t
        t_cand = torch.gather(tc, 1, j[:, None])[:, 0]
        id_cand = torch.gather(ids, 1, j[:, None])[:, 0]
        improve = t_cand < t_b
        t_b = torch.where(improve, t_cand, t_b)
        id_b = torch.where(improve, id_cand, id_b)

        t_next = torch.minimum(tmaxx, tmaxz)
        go_x = tmaxx <= tmaxz
        ix = ix + torch.where(go_x, step_x, 0)
        iz = iz + torch.where(go_x, 0, step_z)
        tmaxx = torch.where(go_x, tmaxx + tdx, tmaxx)
        tmaxz = torch.where(go_x, tmaxz, tmaxz + tdz)
        in_grid = (ix >= 0) & (ix < gs.cx) & (iz >= 0) & (iz < gs.cz)
        still = in_grid & (t_next <= t_out) & (t_next < t_b)
        t_best[lane] = t_b
        id_best[lane] = id_b
        keep = torch.nonzero(still)[:, 0]
        lane, ix, iz, tmaxx, tmaxz = lane[keep], ix[keep], iz[keep], tmaxx[keep], tmaxz[keep]
        tdx, tdz, step_x, step_z = tdx[keep], tdz[keep], step_x[keep], step_z[keep]
        t_out, t_b, id_b = t_out[keep], t_b[keep], id_b[keep]
    return t_best, id_best, t_best < BIG_CUT
