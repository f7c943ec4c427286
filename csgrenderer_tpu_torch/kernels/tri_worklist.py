"""Per-voxel triangle worklists: the 3D voxel-grid packer and the plain walk.

Twin of ``csgrenderer_tpu/kernels/tri_worklist.py`` in what it computes,
not in its layout. The faces of a mesh are binned into cubic voxels by the
exact 13-axis separating-axis (SAT) triangle-box test, so every voxel
lists every face whose surface can appear inside it; a ray walks the
voxels it crosses in order of t (a 3D DDA) and tests only their faces.
Faces whose bounding-box diagonal exceeds 6x the median (a floor quad)
stay "global" and are brute-forced for every ray. Meshes with fewer than
192 faces, or fewer than 192 faces left after that, take no grid.

What the JAX packer stored for the TPU (bf16 hi/lo tables of cell-relative
vertices, occupancy tiers of fixed slots, a flat or two-level paged dense
map, Morton-ordered chunk chains for the stream and HBM modes) answered a
small VMEM and a gather made of one-hot matrix products. A GPU reads an
index directly, so ``pack_tri_grid`` stores the voxel lists as CSR: one
int32 offset per voxel and int32 face ids, ascending within a voxel, over
the mesh's own exact f32 face table. Lists of any length sit in device
memory, so there is no slot cap, no spill and no stream mode.

The cell size is this port's own rule, occupancy-based: cells of edge
``extent / n`` for n = 4, 8, 16, ... are binned in turn, and the first
whose mean list length (over non-empty voxels) is at most
``TARGET_OCCUPANCY`` is taken, or the last before the voxel count passes
``MAX_VOXELS``. (The JAX packer scored the MXU cost of the one-hot
gathers instead.) The binning runs vectorized on the mesh's device, in
chunks of (face, candidate voxel) pairs.

``tri_grid_nearest_hit`` is the plain walk with the semantics of the JAX
``tri_grid_setup`` / ``_dda_advance3`` / ``tri_grid_step``: ``t_in``
starts at 1e-3, an axis with |d| < 1e-12 is flat, ``t_out`` is clamped by
the globals' best t, a voxel's faces are tested before the advance, and
the walk ends when it leaves the grid, passes ``t_out``, or the next voxel
starts at or past the best t. It is the plain version of the CUDA mesh
kernel's grid mode, which takes the same decisions in the same order.

The occupancy mask: most voxels of a mesh's grid are empty (2.4% of the
102,402-face demo mesh's 257 x 67 x 193 voxels hold a list), and a walk
crosses dozens of them a segment. ``pack_tri_grid`` also stores one bit
per block of f x f x f voxels (``TriGridPack.mask``), set iff some voxel
of the block has a non-empty list. The kernel's walk over tables in global
memory stages the mask in each CTA's shared memory and reads a voxel's
two CSR offsets only where its block's bit is set; an unset bit means an
empty list, so the walk visits and tests exactly what it did without the
mask. The block edge f is the finest power of two whose mask fits
``MASK_BUDGET`` bytes (``mask_block``): a fixed rule of the grid's dims.
Where the tables fit a CTA's shared memory the kernel stages the offsets
themselves, and a shared-memory load of an offset costs what one of a
mask word would, so that walk has no mask. The plain walk counts the
visits the mask answers (``masked_visits``), as the kernel's
global-memory walk does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..render.trimesh import HIT_CUT, MISS, MeshScene, brute_nearest, cross, mt_t
from .worklist import add_count

BIG = 1e30
EPS_FLAT = 1e-12  # |d| along an axis below this counts as parallel to it
MIN_GRID_FACES = 192  # the JAX packer's default
FOOTPRINT_FACTOR = 6.0  # "big" face: AABB diagonal > this x the median diagonal
TARGET_OCCUPANCY = 8.0  # mean faces per non-empty voxel the cell rule aims at
MAX_VOXELS = 1 << 24
N_SIDES = (4, 8, 16, 32, 64, 128, 256, 512, 1024)  # cells across the widest extent
PAIR_CHUNK = 1 << 21  # (face, voxel) pairs tested per SAT pass
LIST_SLAB = 32  # voxel-list entries tested per pass of the plain walk
RAY_CHUNK = 1 << 20  # rays the plain walk takes at once
# the most bytes of occupancy mask a CTA of the mesh kernel stages: with
# the CTA's reserved 1 KB, one CTA of the global-memory walk an SM keeps
# the H100's shared-memory carveout at 64 KB and 192 KB of its L1 for the
# face records and lists (PERF.md)
MASK_BUDGET = 62 * 1024


class TriGridStatic(NamedTuple):
    """Grid geometry: ``nx * ny * nz`` cubic voxels of edge ``cell`` from
    (x0, y0, z0), all float64 as the packer binned with them."""

    nx: int
    ny: int
    nz: int
    x0: float
    y0: float
    z0: float
    cell: float

    @property
    def dims(self) -> tuple[int, int, int]:
        return self.nx, self.ny, self.nz

    @property
    def n_voxels(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def max_steps(self) -> int:
        """A 3D DDA visits at most nx + ny + nz - 2 voxels; a walk is capped here."""
        return self.nx + self.ny + self.nz

    @property
    def mask_block(self) -> int:
        """The occupancy mask's block edge f in voxels (``mask_block``)."""
        return mask_block(self.dims)

    @property
    def mask_dims(self) -> tuple[int, int, int]:
        """Blocks of the occupancy mask along x, y and z: the grid padded up
        to a multiple of f."""
        f = self.mask_block
        return tuple(-(-n // f) for n in self.dims)

    @property
    def mask_shift(self) -> int:
        """log2 of the block edge: voxel coordinate i lies in block
        coordinate ``i >> mask_shift``."""
        return self.mask_block.bit_length() - 1

    def f32_params(self) -> dict:
        """The walk's float constants, rounded to f32 as the JAX walk
        rounds them (each bound computed in f64 first)."""
        lo = (self.x0, self.y0, self.z0)
        return dict(
            lo=tuple(np.float32(v) for v in lo),
            hi=tuple(np.float32(v + n * self.cell) for v, n in zip(lo, self.dims)),
            cell=np.float32(self.cell),
            inv_cell=np.float32(1.0 / self.cell),
        )


def mask_block(dims: tuple[int, int, int]) -> int:
    """The finest power-of-two block edge f (voxels) whose occupancy mask,
    one bit per f x f x f block of the grid padded up to a multiple of f,
    fits ``MASK_BUDGET`` bytes."""
    f = 1
    while mask_bytes(dims, f) > MASK_BUDGET:
        f *= 2
    return f


def mask_bytes(dims: tuple[int, int, int], f: int) -> int:
    """Bytes of the occupancy mask of a ``dims`` grid in blocks of edge f:
    one bit a block, in uint32 words, padded to a multiple of 16 bytes."""
    blocks = int(np.prod([-(-n // f) for n in dims]))
    return -(-blocks // 128) * 16


def occupancy_mask(offsets: Tensor, static: TriGridStatic) -> Tensor:
    """The grid's occupancy mask on the offsets' device: bit b of word w
    (uint32) is set iff a voxel of block 32 w + b has a non-empty list.
    Block (mx, my, mz) is ``(mx * My + my) * Mz + mz`` over
    ``static.mask_dims`` (Mx, My, Mz); it holds voxels ``f mx`` to ``f mx +
    f - 1`` along x (and so on), those past the grid's far faces empty."""
    f = static.mask_block
    (nx, ny, nz), (mx, my, mz) = static.dims, static.mask_dims
    full = torch.zeros((mx * f, my * f, mz * f), dtype=torch.bool, device=offsets.device)
    full[:nx, :ny, :nz] = (offsets[1:] > offsets[:-1]).view(nx, ny, nz)
    occupied = full.view(mx, f, my, f, mz, f).any(dim=5).any(dim=3).any(dim=1).reshape(-1)
    n_words = mask_bytes(static.dims, f) // 4
    bits = torch.zeros(n_words * 32, dtype=torch.int64, device=offsets.device)
    bits[:occupied.numel()] = occupied.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=offsets.device)
    return (bits.view(n_words, 32) << shifts).sum(dim=1).to(torch.uint32)


@dataclass(frozen=True)
class TriGridPack:
    """A packed voxel grid. Voxel (ix, iy, iz) has id (ix * ny + iy) * nz
    + iz; its faces are ``face_ids[offsets[v]:offsets[v + 1]]``, ascending.
    ``globals_idx`` are the faces brute-forced for every ray, ascending.
    ``mask`` is the occupancy mask (``occupancy_mask``: one bit per block
    of ``static.mask_block`` cubed voxels, uint32 words, a multiple of 16
    bytes), which the kernel's global-memory walk stages in shared memory.
    ``rungs`` records (n, dims, mean occupancy) of every cell size tried;
    ``pack_seconds`` the packer's wall time."""

    static: TriGridStatic
    offsets: Tensor  # [V + 1] int32
    face_ids: Tensor  # [P] int32
    globals_idx: Tensor  # [G] int32
    mask: Tensor  # [W] uint32, W a multiple of 4
    rungs: tuple = ()
    pack_seconds: float = 0.0

    @property
    def n_globals(self) -> int:
        return self.globals_idx.numel()

    def occupancy(self) -> tuple[float, int, int]:
        """(mean list length over non-empty voxels, max list length,
        non-empty voxels)."""
        lens = self.offsets[1:] - self.offsets[:-1]
        nonempty = int((lens > 0).sum())
        return (self.face_ids.numel() / max(nonempty, 1), int(lens.max()) if lens.numel() else 0,
                nonempty)

    def to(self, device) -> "TriGridPack":
        return TriGridPack(self.static, self.offsets.to(device), self.face_ids.to(device),
                           self.globals_idx.to(device), self.mask.to(device), self.rungs,
                           self.pack_seconds)


def _sum3(x: Tensor) -> Tensor:
    return x[..., 0] + x[..., 1] + x[..., 2]


def tri_box_overlap_pairs(v0: Tensor, v1: Tensor, v2: Tensor, centers: Tensor, half: float
                          ) -> Tensor:
    """Exact SAT triangle-box overlap over (triangle, box) pairs [P, 3]
    (float64), cubic boxes of half-edge ``half``. The formulas and
    epsilons of the JAX ``_tri_box_overlap_pairs``
    (``tri_worklist.py:260-301``), so the keep decisions are the same.
    Returns [P] bool."""
    h = half
    p0, p1, p2 = v0 - centers, v1 - centers, v2 - centers
    # box axes: triangle AABB vs box
    tri_min = torch.minimum(torch.minimum(p0, p1), p2)
    tri_max = torch.maximum(torch.maximum(p0, p1), p2)
    ok = torch.all((tri_min <= h) & (tri_max >= -h), dim=1)
    # triangle plane vs box
    e0, e1, e2 = v1 - v0, v2 - v1, v0 - v2
    n = torch.stack(cross(e0.unbind(-1), e1.unbind(-1)), dim=-1)  # np.cross's operation order
    r = _sum3(h * torch.abs(n))
    s = _sum3(p0 * n)
    ok &= torch.abs(s) <= r + 1e-12
    # nine edge-cross axes
    for e in (e0, e1, e2):
        for j in range(3):
            ax = torch.zeros_like(e)
            ax[:, (j + 1) % 3] = -e[:, (j + 2) % 3]
            ax[:, (j + 2) % 3] = e[:, (j + 1) % 3]
            ra = _sum3(h * torch.abs(ax))
            q0, q1, q2 = _sum3(p0 * ax), _sum3(p1 * ax), _sum3(p2 * ax)
            lo = torch.minimum(torch.minimum(q0, q1), q2)
            hi = torch.maximum(torch.maximum(q0, q1), q2)
            ok &= (lo <= ra + 1e-12) & (hi >= -ra - 1e-12)
    return ok


def _median(x: Tensor) -> float:
    """numpy's median (the mean of the two middle values for an even count)."""
    s = torch.sort(x).values
    k = s.numel() // 2
    return float(s[k]) if s.numel() % 2 else float((s[k - 1] + s[k]) / 2.0)


def _bin(v0, v1, v2, fmin, fmax, idx, g0, cell, dims):
    """(voxel id, face id) int64 pairs of every SAT overlap of the faces
    ``idx`` with the voxels of edge ``cell`` from ``g0``, sorted by voxel,
    faces ascending within a voxel."""
    dev = v0.device
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)
    g0_t = torch.tensor(g0, dtype=torch.float64, device=dev)
    i0 = torch.floor((fmin[idx] - g0_t) / cell).to(torch.int64)
    i1 = torch.minimum(torch.floor((fmax[idx] - g0_t) / cell).to(torch.int64), dims_t - 1)
    span = i1 - i0 + 1
    counts = span[:, 0] * span[:, 1] * span[:, 2]
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    total = int(offsets[-1])
    nx, ny, nz = dims
    keep_ci, keep_fi = [], []
    for s in range(0, total, PAIR_CHUNK):
        pair = torch.arange(s, min(s + PAIR_CHUNK, total), dtype=torch.int64, device=dev)
        frow = torch.searchsorted(offsets, pair, right=True) - 1
        local = pair - offsets[frow]
        sz = span[frow, 2]
        syz = span[frow, 1] * sz
        lx = local // syz
        rem = local - lx * syz
        ly = rem // sz
        lz = rem - ly * sz
        cand = i0[frow] + torch.stack([lx, ly, lz], dim=1)
        centers = g0_t + (cand.to(torch.float64) + 0.5) * cell
        fi = idx[frow]
        hit = tri_box_overlap_pairs(v0[fi], v1[fi], v2[fi], centers, cell / 2.0)
        c = cand[hit]
        keep_ci.append((c[:, 0] * ny + c[:, 1]) * nz + c[:, 2])
        keep_fi.append(fi[hit])
    ci = torch.cat(keep_ci) if keep_ci else torch.zeros(0, dtype=torch.int64, device=dev)
    fi = torch.cat(keep_fi) if keep_fi else torch.zeros(0, dtype=torch.int64, device=dev)
    order = torch.sort(ci, stable=True).indices  # pairs come face-ascending
    return ci[order], fi[order]


def pack_tri_grid(mesh: MeshScene, cell: float | None = None) -> TriGridPack | None:
    """Bin a mesh's faces into a voxel grid on the mesh's device, or
    return None when a grid will not help (too few faces to grid).

    ``cell``: the voxel edge; None takes the occupancy rule (module
    docstring). Any cell bins every face into every voxel it touches, so
    two grids of the same mesh give the same nearest hits; a cell whose
    grid would pass ``MAX_VOXELS`` voxels raises."""
    t_start = time.perf_counter()
    f = mesh.num_faces
    if f < MIN_GRID_FACES:
        return None
    v0 = mesh.v0.to(torch.float64)
    v1 = v0 + mesh.e1.to(torch.float64)
    v2 = v0 + mesh.e2.to(torch.float64)
    fmin = torch.minimum(torch.minimum(v0, v1), v2)
    fmax = torch.maximum(torch.maximum(v0, v1), v2)
    ext3 = fmax - fmin
    diag = torch.sqrt(_sum3(ext3 * ext3))
    big_face = diag > FOOTPRINT_FACTOR * max(_median(diag), 1e-12)
    idx = torch.nonzero(~big_face)[:, 0]
    if idx.numel() < MIN_GRID_FACES:
        return None

    lo = fmin[idx].amin(dim=0)
    hi = fmax[idx].amax(dim=0)
    ext = float((hi - lo).max())
    g0 = (lo - 1e-6).tolist()
    g1 = (hi + 1e-6).tolist()
    best, rungs = None, []
    for n_side in N_SIDES if cell is None else (ext / cell,):
        edge = ext / n_side + 1e-9 if cell is None else float(cell)
        dims = tuple(max(1, int(np.ceil((b - a) / edge))) for a, b in zip(g0, g1))
        if dims[0] * dims[1] * dims[2] > MAX_VOXELS:
            if best is None:
                raise ValueError(f"cell {edge} makes a {dims} grid, over {MAX_VOXELS} voxels")
            break
        ci, fi = _bin(v0, v1, v2, fmin, fmax, idx, g0, edge, dims)
        nonempty = int(torch.unique_consecutive(ci).numel())
        mean_occ = ci.numel() / max(nonempty, 1)
        rungs.append((n_side, dims, mean_occ))
        best = (dims, edge, ci, fi)
        if mean_occ <= TARGET_OCCUPANCY:
            break
    dims, cell, ci, fi = best
    n_vox = dims[0] * dims[1] * dims[2]
    lens = torch.bincount(ci, minlength=n_vox)
    offsets = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)]).to(torch.int32)
    static = TriGridStatic(dims[0], dims[1], dims[2], g0[0], g0[1], g0[2], cell)
    globals_idx = torch.nonzero(big_face)[:, 0].to(torch.int32)
    face_ids = fi.to(torch.int32)
    mask = occupancy_mask(offsets, static)
    if offsets.device.type == "cuda":
        torch.cuda.synchronize(offsets.device)
    return TriGridPack(static, offsets, face_ids, globals_idx, mask, tuple(rungs),
                       time.perf_counter() - t_start)


def tri_grid_nearest_hit(pack: TriGridPack, mesh: MeshScene, o: Tensor, d: Tensor,
                         eps: float = 1e-3, counts: dict | None = None
                         ) -> tuple[Tensor, Tensor, Tensor]:
    """Nearest hit of flat rays [N, 3] through the globals and the voxel
    walk. Returns (t [N], MISS where none; face index [N] int64; hit [N]).

    ``counts``: a dict to which the work is added (as in
    ``worklist.grid_nearest_hit``): the globals' face tests
    (``global_tests``), the rays that enter the grid (``walks``), voxels
    visited (``voxel_visits``, empty ones included), those of them whose
    block's occupancy bit is unset (``masked_visits``: the visits the
    kernel's global-memory walk answers from its mask) and the walk's face
    tests (``face_tests``): what the kernel's grid mode executes for these
    rays.
    """
    n = o.shape[0]
    t_all = torch.empty((n,), dtype=torch.float32, device=o.device)
    id_all = torch.empty((n,), dtype=torch.int64, device=o.device)
    for r0 in range(0, n, RAY_CHUNK):
        t_all[r0:r0 + RAY_CHUNK], id_all[r0:r0 + RAY_CHUNK] = _walk(
            pack, mesh, o[r0:r0 + RAY_CHUNK], d[r0:r0 + RAY_CHUNK], eps, counts)
    return t_all, id_all, t_all < HIT_CUT


def _walk(pack, mesh, o, d, eps, counts):
    gs = pack.static
    f = gs.f32_params()
    dev = o.device
    n = o.shape[0]
    g_ids = pack.globals_idx.to(torch.int64)

    # the globals: brute force, lowest face id first on equal t
    if g_ids.numel():
        t_best, j = brute_nearest(o, d, mesh.v0[g_ids], mesh.e1[g_ids], mesh.e2[g_ids], eps)
        id_best = g_ids[j]
    else:
        t_best = torch.full((n,), MISS, dtype=torch.float32, device=dev)
        id_best = torch.zeros((n,), dtype=torch.int64, device=dev)
    if counts is not None:
        add_count(counts, "global_tests", n * g_ids.numel())

    # DDA setup (JAX tri_grid_setup)
    big = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    t_in = torch.full((n,), 1e-3, dtype=torch.float32, device=dev)
    t_out = big.clone()
    for ax in range(3):
        o_c, d_c = o[:, ax], d[:, ax]
        lo_w, hi_w = float(f["lo"][ax]), float(f["hi"][ax])
        inv = 1.0 / d_c
        t0 = (lo_w - o_c) * inv
        t1 = (hi_w - o_c) * inv
        lo_t = torch.minimum(t0, t1)
        hi_t = torch.maximum(t0, t1)
        flat = torch.abs(d_c) < EPS_FLAT
        inside = (o_c >= lo_w) & (o_c <= hi_w)
        lo_t = torch.where(flat, torch.where(inside, -big, big), lo_t)
        hi_t = torch.where(flat, torch.where(inside, big, -big), hi_t)
        t_in = torch.maximum(t_in, lo_t)
        t_out = torch.minimum(t_out, hi_t)
    t_out = torch.minimum(t_out, t_best)
    march = t_in <= t_out

    cell, inv_cell = float(f["cell"]), float(f["inv_cell"])
    idxs, steps, tmaxs, tds = [], [], [], []
    for ax in range(3):
        o_c, d_c = o[:, ax], d[:, ax]
        lo_w = float(f["lo"][ax])
        p = o_c + t_in * d_c
        # clamp in float first: the far-off points of rays that do not
        # march must not overflow the integer cast
        i0 = torch.clamp(torch.floor((p - lo_w) * inv_cell), 0, gs.dims[ax] - 1).to(torch.int64)
        step = torch.sign(d_c).to(torch.int64)
        flat = torch.abs(d_c) < EPS_FLAT
        next_b = lo_w + (i0 + (step > 0).to(torch.int64)).to(torch.float32) * cell
        idxs.append(i0)
        steps.append(step)
        tmaxs.append(torch.where(flat, big, (next_b - o_c) / d_c))
        tds.append(torch.where(flat, big, torch.abs(cell / d_c)))

    offsets = pack.offsets.to(torch.int64)
    face_ids = pack.face_ids.to(torch.int64)
    mask = pack.mask.to(torch.int64)
    f_blk, (_, mask_ny, mask_nz) = gs.mask_block, gs.mask_dims
    fv0, fe1, fe2 = mesh.v0, mesh.e1, mesh.e2
    # the walk runs on the marching rays only; state below is indexed like ``lane``
    lane = torch.nonzero(march)[:, 0]
    if counts is not None:
        add_count(counts, "walks", lane.numel())
    ix, iy, iz = (x[lane] for x in idxs)
    sx, sy, sz = (x[lane] for x in steps)
    tmx, tmy, tmz = (x[lane] for x in tmaxs)
    tdx, tdy, tdz = (x[lane] for x in tds)
    t_o, t_b, id_b = t_out[lane], t_best[lane], id_best[lane]
    ro, rd = o[lane], d[lane]
    for _ in range(gs.max_steps):
        if lane.numel() == 0:
            break
        # the voxel's faces, LIST_SLAB entries per pass; strict < keeps
        # the first face of least t in list order
        vox = (ix * gs.ny + iy) * gs.nz + iz
        start = offsets[vox]
        length = offsets[vox + 1] - start
        if counts is not None:
            add_count(counts, "voxel_visits", lane.numel())
            add_count(counts, "face_tests", length.sum())
            blk = ((ix // f_blk) * mask_ny + iy // f_blk) * mask_nz + iz // f_blk
            add_count(counts, "masked_visits", (((mask[blk >> 5] >> (blk & 31)) & 1) == 0).sum())
        max_len = int(length.max())
        for c0 in range(0, max_len, LIST_SLAB):
            sub = torch.nonzero(length > c0)[:, 0]
            cols = c0 + torch.arange(min(LIST_SLAB, max_len - c0), device=dev)
            valid = cols[None, :] < length[sub, None]
            fid = face_ids[torch.where(valid, start[sub, None] + cols[None, :], 0)]
            so = tuple(ro[sub, k][:, None] for k in range(3))
            sd = tuple(rd[sub, k][:, None] for k in range(3))
            t = mt_t(so, sd, *(tuple(x[fid][..., k] for k in range(3)) for x in (fv0, fe1, fe2)),
                     eps)
            t = torch.where(valid, t, MISS)
            j = torch.argmin(t, dim=1)
            tj = torch.gather(t, 1, j[:, None])[:, 0]
            take = tj < t_b[sub]
            t_b[sub] = torch.where(take, tj, t_b[sub])
            id_b[sub] = torch.where(take, torch.gather(fid, 1, j[:, None])[:, 0], id_b[sub])

        # one 3-axis DDA advance (JAX _dda_advance3)
        t_next = torch.minimum(torch.minimum(tmx, tmy), tmz)
        go_x = (tmx <= tmy) & (tmx <= tmz)
        go_y = ~go_x & (tmy <= tmz)
        go_z = ~go_x & ~go_y
        ix = ix + torch.where(go_x, sx, 0)
        iy = iy + torch.where(go_y, sy, 0)
        iz = iz + torch.where(go_z, sz, 0)
        tmx = torch.where(go_x, tmx + tdx, tmx)
        tmy = torch.where(go_y, tmy + tdy, tmy)
        tmz = torch.where(go_z, tmz + tdz, tmz)
        in_grid = ((ix >= 0) & (ix < gs.nx) & (iy >= 0) & (iy < gs.ny)
                   & (iz >= 0) & (iz < gs.nz))
        still = in_grid & (t_next <= t_o) & (t_next < t_b)
        t_best[lane] = t_b
        id_best[lane] = id_b
        keep = torch.nonzero(still)[:, 0]
        lane = lane[keep]
        ix, iy, iz, sx, sy, sz = ix[keep], iy[keep], iz[keep], sx[keep], sy[keep], sz[keep]
        tmx, tmy, tmz, tdx, tdy, tdz = (tmx[keep], tmy[keep], tmz[keep], tdx[keep], tdy[keep],
                                        tdz[keep])
        t_o, t_b, id_b, ro, rd = t_o[keep], t_b[keep], id_b[keep], ro[keep], rd[keep]
    return t_best, id_best
