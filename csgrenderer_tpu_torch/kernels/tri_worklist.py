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
mask. The block edge f is the finest power of two whose mask, with the
coarse level below, fits ``MASK_BUDGET`` bytes (``mask_block``): a fixed
rule of the grid's dims. Where the tables fit a CTA's shared memory the
kernel stages the offsets themselves, and a shared-memory load of an
offset costs what one of a mask word would, so that walk has no mask. The
plain walk counts the visits the mask answers (``masked_visits``), as the
kernel's global-memory walk does.

The coarse level: on a grid of f > 1, a second mask
(``TriGridPack.coarse_mask``), one bit per block of C x C x C voxels, C =
``COARSE_FACTOR`` x f (``coarse_block``), staged with the fine one. The
kernel's walk over global memory is two-level there
(``tri_grid_nearest_hit(two_level=True)`` is its plain version): each turn
first reads its voxel's coarse bit. In an empty coarse block the turn
leaves the block (a coarse skip): along each axis the block's far face is
crossed at the voxel's next crossing plus the voxels left in the block
times the axis's step in t, and the least of the three is the exit; the
axis it is left by moves to the next block's first voxel, and each other
axis by the crossings it has before the exit: their span in t times |d| /
cell, rounded up, one fewer where the last of them, summed as the exit is,
does not come before the exit, and at most to the block's far edge. So the
count errs low: a rounding can add a visit to a voxel the ray grazes, never
step past one it crosses. In an occupied block the turn is the flat walk's
step. Every face lies in every voxel it touches and occupied blocks are
walked voxel by voxel, so the walk finds the flat walk's nearest hit and
tests its faces; a walk can end one voxel apart from the flat one where its
hit lies on a voxel's face, since a crossing re-derived after a skip rounds
apart from the flat walk's running sum. A grid of f = 1 has no coarse level
and its walk is flat: a skip there saves at most three fine steps, and on
the card costs more than it saves (PERF.md). A grid of f > 1 has over
507,904 voxels, so its CSR offsets alone (4 bytes a voxel) exceed what a
CTA can stage, and the kernel always reads its tables from global memory.
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
# the most bytes of occupancy mask (both levels) a CTA of the mesh kernel
# stages: with the CTA's reserved 1 KB, one CTA of the global-memory walk an
# SM keeps the H100's shared-memory carveout at 64 KB and 192 KB of its L1
# for the face records and lists (PERF.md)
MASK_BUDGET = 62 * 1024
COARSE_FACTOR = 4  # the coarse level's block edge in fine blocks, where f > 1 (PERF.md)


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

    @property
    def coarse_block(self) -> int:
        """The coarse mask's block edge C in voxels, 0 where the grid has
        no coarse level (``coarse_block``)."""
        return coarse_block(self.dims)

    @property
    def coarse_dims(self) -> tuple[int, int, int]:
        """Blocks of the coarse mask along x, y and z; (0, 0, 0) where
        there is none."""
        c = self.coarse_block
        return tuple(-(-n // c) for n in self.dims) if c else (0, 0, 0)

    @property
    def coarse_shift(self) -> int:
        """log2 of C: voxel coordinate i lies in coarse block ``i >>
        coarse_shift``; 0 where there is no coarse level (C >= 4 where
        there is)."""
        c = self.coarse_block
        return c.bit_length() - 1 if c else 0

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
    fits ``MASK_BUDGET`` bytes, with the coarse mask of blocks of
    ``COARSE_FACTOR`` x f where f > 1."""
    f = 1
    while (mask_bytes(dims, f) + (mask_bytes(dims, COARSE_FACTOR * f) if f > 1 else 0)
           > MASK_BUDGET):
        f *= 2
    return f


def coarse_block(dims: tuple[int, int, int]) -> int:
    """The coarse mask's block edge C (voxels): ``COARSE_FACTOR`` x f where
    f > 1, so 8 for the 102,402-face mesh's 257 x 67 x 193 grid (f = 2);
    0, no coarse level and a flat walk, where f = 1, as for the
    15,362-face mesh's 65 x 27 x 43."""
    f = mask_block(dims)
    return COARSE_FACTOR * f if f > 1 else 0


def mask_bytes(dims: tuple[int, int, int], f: int) -> int:
    """Bytes of the occupancy mask of a ``dims`` grid in blocks of edge f:
    one bit a block, in uint32 words, padded to a multiple of 16 bytes."""
    blocks = int(np.prod([-(-n // f) for n in dims]))
    return -(-blocks // 128) * 16


def occupancy_mask(offsets: Tensor, static: TriGridStatic, coarse: bool = False) -> Tensor:
    """The grid's occupancy mask on the offsets' device: bit b of word w
    (uint32) is set iff a voxel of block 32 w + b has a non-empty list.
    Block (mx, my, mz) is ``(mx * My + my) * Mz + mz`` over
    ``static.mask_dims`` (Mx, My, Mz); it holds voxels ``f mx`` to ``f mx +
    f - 1`` along x (and so on), those past the grid's far faces empty.
    ``coarse``: the coarse mask, blocks of ``static.coarse_block`` over
    ``static.coarse_dims``, no word where the grid has no coarse level."""
    f = static.coarse_block if coarse else static.mask_block
    if f == 0:
        return torch.zeros((0,), dtype=torch.uint32, device=offsets.device)
    (nx, ny, nz) = static.dims
    (mx, my, mz) = static.coarse_dims if coarse else static.mask_dims
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
    bytes) and ``coarse_mask`` its coarse level (blocks of
    ``static.coarse_block`` cubed voxels; empty where there is none), which
    the kernel's global-memory walk stages in shared memory.
    ``rungs`` records (n, dims, mean occupancy) of every cell size tried;
    ``pack_seconds`` the packer's wall time."""

    static: TriGridStatic
    offsets: Tensor  # [V + 1] int32
    face_ids: Tensor  # [P] int32
    globals_idx: Tensor  # [G] int32
    mask: Tensor  # [W] uint32, W a multiple of 4
    coarse_mask: Tensor  # [Wc] uint32, Wc a multiple of 4 (0: no coarse level)
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
                           self.globals_idx.to(device), self.mask.to(device),
                           self.coarse_mask.to(device), self.rungs, self.pack_seconds)


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
    coarse_mask = occupancy_mask(offsets, static, coarse=True)
    if offsets.device.type == "cuda":
        torch.cuda.synchronize(offsets.device)
    return TriGridPack(static, offsets, face_ids, globals_idx, mask, coarse_mask, tuple(rungs),
                       time.perf_counter() - t_start)


def tri_grid_nearest_hit(pack: TriGridPack, mesh: MeshScene, o: Tensor, d: Tensor,
                         eps: float = 1e-3, counts: dict | None = None, two_level: bool = False
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
    rays. ``two_level``: the kernel's walk, which on a grid with a coarse
    level jumps the coarse mask's empty blocks (module docstring);
    ``counts`` then also takes those jumps (``coarse_skips``), and
    ``voxel_visits`` the fine visits alone.
    """
    walk = _walk_two_level if two_level and pack.static.coarse_block else _walk
    n = o.shape[0]
    t_all = torch.empty((n,), dtype=torch.float32, device=o.device)
    id_all = torch.empty((n,), dtype=torch.int64, device=o.device)
    for r0 in range(0, n, RAY_CHUNK):
        t_all[r0:r0 + RAY_CHUNK], id_all[r0:r0 + RAY_CHUNK] = walk(
            pack, mesh, o[r0:r0 + RAY_CHUNK], d[r0:r0 + RAY_CHUNK], eps, counts)
    return t_all, id_all, t_all < HIT_CUT


def _walk_start(pack, mesh, o, d, eps, counts):
    """The globals, then the DDA set-up (JAX tri_grid_setup), of both
    walks. Returns the rays' best (t, face) after the globals, the indices
    ``lane`` of the rays that march, and their walk state indexed like
    ``lane``: per axis (lists x, y, z) the voxel, step, next crossing and
    step in t; and t_out, the best (t, face), origins and directions."""
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

    # the walk runs on the marching rays only; state below is indexed like ``lane``
    lane = torch.nonzero(march)[:, 0]
    if counts is not None:
        add_count(counts, "walks", lane.numel())
    axes = [[x[lane] for x in xs] for xs in (idxs, steps, tmaxs, tds)]
    rays = [t_out[lane], t_best[lane], id_best[lane], o[lane], d[lane]]
    return t_best, id_best, lane, axes, rays


def _test_lists(face_ids, mesh, start, length, rays, eps):
    """Test the faces of each ray's voxel list (``length`` entries of
    ``face_ids`` from ``start``), LIST_SLAB entries per pass, into its best
    (t, face) in ``rays`` (as ``_walk_start`` returns them); strict < keeps
    the first face of least t in list order."""
    _, t_b, id_b, ro, rd = rays
    max_len = int(length.max())
    for c0 in range(0, max_len, LIST_SLAB):
        sub = torch.nonzero(length > c0)[:, 0]
        cols = c0 + torch.arange(min(LIST_SLAB, max_len - c0), device=length.device)
        valid = cols[None, :] < length[sub, None]
        fid = face_ids[torch.where(valid, start[sub, None] + cols[None, :], 0)]
        so = tuple(ro[sub, k][:, None] for k in range(3))
        sd = tuple(rd[sub, k][:, None] for k in range(3))
        t = mt_t(so, sd, *(tuple(x[fid][..., k] for k in range(3))
                           for x in (mesh.v0, mesh.e1, mesh.e2)), eps)
        t = torch.where(valid, t, MISS)
        j = torch.argmin(t, dim=1)
        tj = torch.gather(t, 1, j[:, None])[:, 0]
        take = tj < t_b[sub]
        t_b[sub] = torch.where(take, tj, t_b[sub])
        id_b[sub] = torch.where(take, torch.gather(fid, 1, j[:, None])[:, 0], id_b[sub])


def _walk_on(gs, t_next, lane, axes, rays, t_best, id_best):
    """After a turn's advance to the voxel in ``axes``, which the turn left
    at ``t_next``: write the rays' best (t, face) back and keep those whose
    walk goes on (inside the grid, not past t_out, and the next voxel
    starting before the best t). Returns the kept lanes and state."""
    ix, iy, iz = axes[0]
    t_o, t_b, id_b = rays[:3]
    in_grid = ((ix >= 0) & (ix < gs.nx) & (iy >= 0) & (iy < gs.ny)
               & (iz >= 0) & (iz < gs.nz))
    still = in_grid & (t_next <= t_o) & (t_next < t_b)
    t_best[lane] = t_b
    id_best[lane] = id_b
    keep = torch.nonzero(still)[:, 0]
    return lane[keep], [[x[keep] for x in xs] for xs in axes], [x[keep] for x in rays]


def _block(shift, ny, nz, ix, iy, iz):
    """The bit index of voxel (ix, iy, iz)'s block in a mask of blocks of
    2^shift voxels on an edge, ny x nz along y and z."""
    return ((ix >> shift) * ny + (iy >> shift)) * nz + (iz >> shift)


def _bit(words, b):
    """Whether bit ``b`` of the mask ``words`` (int64 of uint32) is set."""
    return ((words[b >> 5] >> (b & 31)) & 1) == 1


def crossings_before(t_exit: Tensor, tm: Tensor, td: Tensor, d: Tensor, inv_cell: float,
                     left: Tensor) -> Tensor:
    """The voxel boundaries an axis crosses before a skip's exit ``t_exit``
    (f32, as the kernel's follow_axis counts them): of its next crossing
    ``tm`` and every step ``td`` after it, at most ``left`` (the voxels
    left in the block). Their span in t times |d| / cell, rounded up, and
    one fewer where the last of them, ``tm + (m - 1) td`` as the exit is
    summed, does not come before ``t_exit``: the count errs low, since an
    undercount only adds a visit and an overcount would step past a voxel
    the ray crosses (the product rounds far below one step, so one check
    does). A flat axis (``tm`` at BIG) takes none."""
    n = torch.ceil((t_exit - tm) * (torch.abs(d) * inv_cell))
    m = torch.minimum(torch.maximum(n, torch.zeros_like(n)), left.to(torch.float32))
    return torch.where((m > 0) & (tm + (m - 1) * td >= t_exit), m - 1, m)


def _walk(pack, mesh, o, d, eps, counts):
    gs = pack.static
    t_best, id_best, lane, axes, rays = _walk_start(pack, mesh, o, d, eps, counts)
    offsets = pack.offsets.to(torch.int64)
    face_ids = pack.face_ids.to(torch.int64)
    mask = pack.mask.to(torch.int64)
    _, mask_ny, mask_nz = gs.mask_dims
    for _ in range(gs.max_steps):
        if lane.numel() == 0:
            break
        (ix, iy, iz), (sx, sy, sz), (tmx, tmy, tmz), (tdx, tdy, tdz) = axes
        # the voxel's faces
        vox = (ix * gs.ny + iy) * gs.nz + iz
        start = offsets[vox]
        length = offsets[vox + 1] - start
        if counts is not None:
            add_count(counts, "voxel_visits", lane.numel())
            add_count(counts, "face_tests", length.sum())
            blk = _block(gs.mask_shift, mask_ny, mask_nz, ix, iy, iz)
            add_count(counts, "masked_visits", (~_bit(mask, blk)).sum())
        _test_lists(face_ids, mesh, start, length, rays, eps)

        # one 3-axis DDA advance (JAX _dda_advance3)
        t_next = torch.minimum(torch.minimum(tmx, tmy), tmz)
        go_x = (tmx <= tmy) & (tmx <= tmz)
        go_y = ~go_x & (tmy <= tmz)
        go_z = ~go_x & ~go_y
        axes[0] = [ix + torch.where(go_x, sx, 0), iy + torch.where(go_y, sy, 0),
                   iz + torch.where(go_z, sz, 0)]
        axes[2] = [torch.where(go_x, tmx + tdx, tmx), torch.where(go_y, tmy + tdy, tmy),
                   torch.where(go_z, tmz + tdz, tmz)]
        lane, axes, rays = _walk_on(gs, t_next, lane, axes, rays, t_best, id_best)
    return t_best, id_best


def _walk_two_level(pack, mesh, o, d, eps, counts):
    """``_walk`` with the coarse level (module docstring): the kernel's
    global-memory walk, operation for operation. A turn in an empty coarse
    block jumps to the block's exit; a turn in an occupied one is the flat
    walk's (the voxel's list, then one DDA step)."""
    gs = pack.static
    t_best, id_best, lane, axes, rays = _walk_start(pack, mesh, o, d, eps, counts)
    inv_cell = float(gs.f32_params()["inv_cell"])
    offsets = pack.offsets.to(torch.int64)
    face_ids = pack.face_ids.to(torch.int64)
    mask, coarse = pack.mask.to(torch.int64), pack.coarse_mask.to(torch.int64)
    _, mask_ny, mask_nz = gs.mask_dims
    _, coarse_ny, coarse_nz = gs.coarse_dims
    edge = gs.coarse_block - 1  # a voxel's place in its coarse block: i & edge
    for _ in range(gs.max_steps):
        if lane.numel() == 0:
            break
        idx, step, tmax, td = axes
        rd = rays[4]
        skip = ~_bit(coarse, _block(gs.coarse_shift, coarse_ny, coarse_nz, *idx))
        # a fine turn: the voxel's faces, as _walk
        vox = (idx[0] * gs.ny + idx[1]) * gs.nz + idx[2]
        start = offsets[vox]
        length = torch.where(skip, 0, offsets[vox + 1] - start)
        if counts is not None:
            fine = ~skip
            add_count(counts, "coarse_skips", skip.sum())
            add_count(counts, "voxel_visits", fine.sum())
            add_count(counts, "face_tests", length.sum())
            empty = ~_bit(mask, _block(gs.mask_shift, mask_ny, mask_nz, *idx))
            add_count(counts, "masked_visits", (fine & empty).sum())
        _test_lists(face_ids, mesh, start, length, rays, eps)

        # the turn's end along each axis: the voxel's next crossing, or in
        # an empty block that plus the voxels left in it times the step in t
        left = [torch.where(skip, torch.where(s > 0, edge - (i & edge), i & edge), 0)
                for i, s in zip(idx, step)]
        end = [torch.where(skip, tm + r.to(torch.float32) * t_d, tm)
               for tm, r, t_d in zip(tmax, left, td)]
        t_next = torch.minimum(torch.minimum(end[0], end[1]), end[2])
        go_x = (end[0] <= end[1]) & (end[0] <= end[2])
        go_y = ~go_x & (end[1] <= end[2])
        go = (go_x, go_y, ~go_x & ~go_y)
        for ax in range(3):
            i, s, r, t_d, tm = idx[ax], step[ax], left[ax], td[ax], tmax[ax]
            # past a skipped block, an axis it was not left by takes its
            # crossings before the exit
            m = crossings_before(t_next, tm, t_d, rd[:, ax], inv_cell, r)
            moved = skip & ~go[ax]
            tmax[ax] = torch.where(go[ax], end[ax] + t_d, torch.where(moved, tm + m * t_d, tm))
            idx[ax] = torch.where(go[ax], i + s * (r + 1),
                                  torch.where(moved, i + s * m.to(torch.int64), i))
        lane, axes, rays = _walk_on(gs, t_next, lane, axes, rays, t_best, id_best)
    return t_best, id_best
