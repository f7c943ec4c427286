"""The CSG tape kernel: packing, the CUDA launch, and its plain version.

Twin of ``csgrenderer_tpu/kernels/tape_kernel.py``.
``render_image_tape_kernel`` renders a ``CompiledTape`` in one of two
evaluations:

- event flip (production): the nearest CSG surface along a ray is the
  smallest leaf boundary t where the root's membership flips; membership
  just below and just above a boundary is exact comparison algebra on the
  leaves' raw intervals, folded through the postfix tape. With
  ``partition`` the root's union of disjoint solids splits into clusters
  (``scene/partition.py``), each evaluated on its own ops and leaves:
  O(sum L_c^2) flip work instead of O(L^2);
- the interval-list audit (``with_overflow=True``): the whole tape runs as
  a stack machine over interval lists of at most ``tape.k`` spans, and the
  spans that capacity cuts away are counted and returned as ``over``
  (0: every evaluation was exact). Away from overflow it gives the event
  flip's image.

Attribution (normal and material) is the leaf whose surface lies nearest
the hit point. On a tape of ``TREE_MIN_CLUSTERS`` or more bounded clusters
the packer also builds a ``ClusterTree``, a binary tree of padded world
boxes over them, and the kernel's event flip without NEE walks it: a ray
evaluates the clusters holding an unbounded leaf and those whose boxes it
reaches nearer than its best flip so far, and a hit scores the leaves of
the unbounded clusters and of the clusters whose boxes hold it (every leaf
where none scores below half the pad). The image is the one of a walk over
every cluster and a score of every leaf, which the plain version computes.

Where the tensors lie decides what runs:

- on a CUDA device, the hand-written kernel ``csrc/tape_kernel.cu``
  (built for sm_90a at first use) is launched, or an error is raised;
- on the CPU, the plain torch version ``render_image_tape_plain`` runs:
  ``render/integrator.render_image`` with the event-flip hit function.

``nee=True`` adds next-event estimation toward the tape's emissive sphere
leaves (``render/lights.py``): the kernel reads each lamp's centre, radius
and emission from its leaf table row, so a re-baked tape moves its lamps.
Both count the leaf intervals their path segments compute (the event
flip's, each cluster's leaves; the audit's, one a PUSH; shadow rays are not
counted), which ``counts`` takes under ``"leaf_tests"``: the kernel adds
them into a device word of its own, the plain version takes segments x
leaves (the clusters partition the leaves, so every segment computes each
leaf's interval once). Through the cluster tree the kernel also counts the
attribution's leaf scores into a second word (``"leaf_scores"``), and the
plain version replays the tree's walks to count both as the kernel does.
``LAUNCHES`` counts kernel launches (``LAUNCHES_BY_MODE`` per mode:
"global" is one cluster covering the tape, "clustered" two or more,
"audit" the interval-list mode, each also with "-nee";
``LAUNCHES_BY_SEARCH``: "tree" where the launch walked the cluster tree,
else "flat"); only the launch site adds to them.

A launch of the event flip without NEE at interval cap 8 that is handed
``counts`` may run the kernel's stats instantiation (``build.stats_launch``:
one such launch in ``build.STATS_EVERY`` while the program's spans
record): the same image and counts, and a block of work counts that
``counts`` takes under ``"stats"``: the segment loop's warp turns and,
through the cluster tree, the tree walk's warp turns and node visits
(the first one or three of ``build.STATS_WORDS``). The plain version's
replay of the tree walks counts the same node visits (``"node_visits"``,
``tree_walk``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..math import quaternion as quat
from ..math import vec
from ..render import integrator, intersect, interval, tape_eval
from ..render.integrator import SKY_MODES, SurfaceHit
from ..render.intersect import T_FAR
from ..render.interval import SURFACE_CUTOFF as CUT
from ..render.lights import SphereLights, extract_tape_lights
from ..scene.graph import NodeType
from ..scene.partition import leaf_bounds, partition_tape
from ..scene.tape import OP_INTERSECT, OP_PUSH, OP_UNION, CompiledTape, stack_depth
from ..utils import profiling
from . import build
from .megakernel import CAM_SIZE, JITTER_ON_CPU_ONLY, pack_camera
from .worklist import add_count

KERNEL_SOURCE = "tape_kernel"
LEAF_ROW = 16  # rot(4) pos(3) params(4) kind param albedo(3): the JAX layout
MAX_LEAVES = 256  # leaves of a tape: the kernel's largest interval-array cap (csrc kMaxLeaves)
MAX_STACK = 64  # the kernel's membership bit stacks and audit list stack (csrc kMaxStack)
MAX_K = 16  # the audit mode's slots per interval list (csrc kMaxK)
INTERVAL_CAPS = (8, 32, MAX_LEAVES)  # the kernel's interval-array sizes (csrc launch_cap)
EPS = 1e-3  # hit epsilon along t
TREE_MIN_CLUSTERS = 16  # bounded clusters from which the packer builds a cluster tree
TREE_STACK = 16  # the kernel's tree walks' stack (csrc kTreeStack)
TREE_PAD = 1e-3  # the tree's boxes' pad, a share of the bounded clusters' diagonal
FLAT_DIR = 1e-20  # |d| below this: the ray runs along a box's slab (csrc kFlatDir)
# candidate-by-leaf membership elements per chunk of the plain version
_PLAIN_CHUNK = 1 << 26

LAUNCHES = 0
LAUNCHES_BY_MODE = {"global": 0, "clustered": 0, "global-nee": 0, "clustered-nee": 0,
                    "audit": 0, "audit-nee": 0}
LAUNCHES_BY_SEARCH = {"flat": 0, "tree": 0}
build.count_launches(__name__, "LAUNCHES", "LAUNCHES_BY_MODE", "LAUNCHES_BY_SEARCH")

_NO_LAMPS = "nee=True but the tape has no emissive sphere leaves"


class ClusterTree(NamedTuple):
    """A binary tree of padded world boxes over a tape's bounded clusters,
    as the kernel walks it (``cluster_tree``).

    - ``lo``, ``hi`` [M, 3] f32: node i's box. A leaf node's is the union of
      its cluster's leaves' AABBs (``partition.leaf_bounds``) widened by
      ``pad`` and rounded outward, an inner node's the union of its
      children's. Node 0 is the root; the nodes are in depth-first order.
    - ``link`` [M, 2] int32: an inner node's left child, and its right
      child << 2 | the axis its clusters were split on; a leaf node's
      ~cluster, and 0.
    - ``free`` [U] int32: the clusters holding an unbounded leaf (a
      half-space), in cluster order, which every ray evaluates and every hit
      scores.
    - ``pad``: the boxes' pad in world units; ``score_bound``, half of it
      in float32, the best score below which the leaves near a hit stand
      for all.
    """

    lo: Tensor
    hi: Tensor
    link: Tensor
    free: Tensor
    pad: float
    score_bound: float

    def to(self, device) -> "ClusterTree":
        return self._replace(**{f: getattr(self, f).to(device)
                                for f in ("lo", "hi", "link", "free")})

    @property
    def words(self) -> Tensor:
        """The nodes as the kernel stages them: [M, 8] int32, (lo, link0,
        hi, link1) with the boxes' float32 bits."""
        return torch.cat([self.lo.view(torch.int32), self.link[:, :1],
                          self.hi.view(torch.int32), self.link[:, 1:]], dim=1)


def _round_out(x: np.ndarray, down: bool) -> np.ndarray:
    """float64 x as float32, rounded toward -inf (``down``) or +inf."""
    y = x.astype(np.float32)
    step = np.nextafter(y, np.float32(-np.inf if down else np.inf))
    return np.where(y > x, step, y) if down else np.where(y < x, step, y)


def cluster_tree(tape: CompiledTape, clusters) -> ClusterTree | None:
    """The cluster tree over ``clusters`` (``PackedTape.clusters``), or None
    when fewer than ``TREE_MIN_CLUSTERS`` of them are bounded (a
    conservative threshold: the tree already wins from 8, PERF.md §6).

    A cluster is bounded when all its leaves are; its box is their AABBs'
    union (the subtracted leaves too, which the attribution scores), padded
    by ``TREE_PAD`` of the bounded boxes' diagonal. The tree splits its
    clusters at the median of their boxes' centres along the axis where the
    centres spread widest, down to one cluster a leaf node.
    """
    bounds = leaf_bounds(tape)
    boxes, free = {}, []
    for c, (_, leaves) in enumerate(clusters):
        own = [bounds[leaf] for leaf in leaves]
        if any(b is None for b in own):
            free.append(c)
            continue
        boxes[c] = (np.min([b[0] for b in own], axis=0), np.max([b[1] for b in own], axis=0))
    if len(boxes) < TREE_MIN_CLUSTERS:
        return None
    lo_all = np.min([b[0] for b in boxes.values()], axis=0)
    hi_all = np.max([b[1] for b in boxes.values()], axis=0)
    pad = TREE_PAD * float(np.linalg.norm(hi_all - lo_all))
    centre = {c: (lo + hi) / 2 for c, (lo, hi) in boxes.items()}
    nodes: list = []

    def build(ids, depth):
        if depth >= TREE_STACK:
            raise ValueError(f"the cluster tree is deeper than the kernel's {TREE_STACK} levels")
        at = len(nodes)
        nodes.append(None)
        if len(ids) == 1:
            lo, hi = boxes[ids[0]]
            nodes[at] = (_round_out(lo - pad, True), _round_out(hi + pad, False), ~ids[0], 0)
            return at
        spread = np.ptp([centre[c] for c in ids], axis=0)
        axis = int(np.argmax(spread))
        order = sorted(ids, key=lambda c: (centre[c][axis], c))
        left = build(order[:len(order) // 2], depth + 1)
        right = build(order[len(order) // 2:], depth + 1)
        nodes[at] = (np.minimum(nodes[left][0], nodes[right][0]),
                     np.maximum(nodes[left][1], nodes[right][1]), left, right << 2 | axis)
        return at

    build(sorted(boxes), 0)
    dev = tape.device
    return ClusterTree(
        lo=torch.tensor(np.stack([n[0] for n in nodes]), dtype=torch.float32, device=dev),
        hi=torch.tensor(np.stack([n[1] for n in nodes]), dtype=torch.float32, device=dev),
        link=torch.tensor([n[2:] for n in nodes], dtype=torch.int32, device=dev),
        free=torch.tensor(free, dtype=torch.int32, device=dev),
        pad=pad,
        score_bound=float(np.float32(pad / 2)),
    )


@dataclass(frozen=True)
class PackedTape:
    """A tape prepared for the kernel (host-side, once per tape).

    ``clusters`` is the host tuple ``((ops, leaf_ids), ...)`` in evaluation
    order; global evaluation is one cluster of the whole tape. The tables
    hold the same on the tape's device:

    - ``leaf_table`` [L, 16] f32 and ``leaf_types`` [L] int32;
    - ``ops`` [n_ops] int32, each ``opcode | slot << 2`` where a PUSH's slot
      is the leaf's position in its cluster's leaf list;
    - ``cluster_table`` [C, 4] int32: op offset, op count, leaf offset and
      leaf count of each cluster in ``ops`` / ``leaf_ids``;
    - ``leaf_ids`` [sum L_c] int32;
    - ``lamp_ids`` [n_lamps] int32, the emissive sphere leaves
      (``extract_tape_lights``), or None when the tape has none;
    - ``list_ops`` [len(tape.ops)] int32, the whole tape as the audit mode
      runs it: ``opcode | leaf << 2``;
    - ``tree``: the ``ClusterTree`` over the bounded clusters, or None
      (fewer than ``TREE_MIN_CLUSTERS`` of them);
    - ``tables``: all of the above but the clusters' host tuple, in one
      block the kernel stages in shared memory (``table_layout``): the leaf
      table's f32 words, then the int32 tables (the tree's nodes as
      ``ClusterTree.words`` and its unbounded clusters), each at a 16-byte
      aligned offset and padded to 16 bytes.
    """

    tape: CompiledTape
    clusters: tuple
    leaf_table: Tensor
    leaf_types: Tensor
    ops: Tensor
    cluster_table: Tensor
    leaf_ids: Tensor
    lamp_ids: Tensor | None
    list_ops: Tensor
    tables: Tensor  # [table_bytes / 4] f32 (int32 words past the leaf table)
    tree: ClusterTree | None = None

    @property
    def mode(self) -> str:
        return "global" if len(self.clusters) == 1 else "clustered"

    @property
    def device(self) -> torch.device:
        return self.leaf_table.device

    @property
    def lights(self) -> SphereLights | None:
        """The lamps as the plain version's ``SphereLights``, read from the
        leaf table as the kernel reads them: position, |radius|, albedo."""
        if self.lamp_ids is None:
            return None
        rows = self.leaf_table[self.lamp_ids.long()]
        return SphereLights(rows[:, 4:7], torch.abs(rows[:, 7]), rows[:, 13:16])

    @property
    def layout(self) -> "TableLayout":
        return table_layout(self)

    @property
    def table_bytes(self) -> int:
        """The bytes a CTA stages in shared memory (a multiple of 16)."""
        return self.tables.numel() * 4

    @property
    def interval_cap(self) -> int:
        """The kernel's interval-array slots for this tape: the smallest of
        ``INTERVAL_CAPS`` that holds its largest cluster's leaves."""
        largest = max(len(leaves) for _, leaves in self.clusters)
        return next(cap for cap in INTERVAL_CAPS if cap >= largest)

    def to(self, device) -> "PackedTape":
        lamp_ids = None if self.lamp_ids is None else self.lamp_ids.to(device)
        tree = None if self.tree is None else self.tree.to(device)
        return PackedTape(self.tape.to(device), self.clusters, *(
            getattr(self, f).to(device)
            for f in ("leaf_table", "leaf_types", "ops", "cluster_table", "leaf_ids")
        ), lamp_ids, self.list_ops.to(device), self.tables.to(device), tree)


class TableLayout(NamedTuple):
    """Byte offsets of the int32 sections of ``PackedTape.tables`` (the
    leaf table is at 0) and the block's length."""

    type_at: int
    ops_at: int
    ids_at: int
    cl_at: int
    lamp_at: int
    list_at: int
    node_at: int
    free_at: int
    nbytes: int


def _pad16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def table_layout(packed: PackedTape) -> TableLayout:
    """Where ``PackedTape.tables`` holds what: the [L, 16] f32 leaf table
    from byte 0, then the leaf types, cluster ops, cluster leaf ids, [C, 4]
    cluster table, lamp ids, list ops, the tree's [M, 8] nodes and its
    unbounded clusters (both empty without a tree), each padded to 16
    bytes."""
    at = [packed.leaf_table.numel() * 4]
    for t in _int_tables(packed):
        at.append(at[-1] + _pad16(4 * t.numel()))
    return TableLayout(*at)


def _int_tables(packed: PackedTape) -> tuple:
    none = packed.leaf_types.new_zeros(0)
    lamps = none if packed.lamp_ids is None else packed.lamp_ids
    tree = packed.tree
    nodes, free = (none, none) if tree is None else (tree.words.reshape(-1), tree.free)
    return (packed.leaf_types, packed.ops, packed.leaf_ids, packed.cluster_table.reshape(-1),
            lamps, packed.list_ops, nodes, free)


def _tables(packed: PackedTape) -> Tensor:
    lay = table_layout(packed)
    tab = torch.zeros(lay.nbytes // 4, dtype=torch.float32, device=packed.leaf_table.device)
    tab[:packed.leaf_table.numel()] = packed.leaf_table.reshape(-1)
    words = tab.view(torch.int32)
    for at, t in zip(lay[:-1], _int_tables(packed)):
        words[at // 4:at // 4 + t.numel()] = t
    return tab


def _leaf_table(tape: CompiledTape) -> Tensor:
    tab = torch.zeros((tape.n_leaves, LEAF_ROW), dtype=torch.float32, device=tape.device)
    tab[:, 0:4] = tape.leaf_rot
    tab[:, 4:7] = tape.leaf_pos
    tab[:, 7:11] = tape.leaf_params
    tab[:, 11] = tape.mat_kind.to(torch.float32)
    tab[:, 12] = tape.mat_param
    tab[:, 13:16] = tape.albedo
    return tab


def pack_program(tape: CompiledTape, partition: bool | str | tuple = "auto") -> PackedTape:
    """Cluster the tape (on the host, once) and build the kernel's tables.

    ``partition``: "auto" clusters a root that unions spatially disjoint
    solids and evaluates globally otherwise; True requires clusters (raises
    when nothing splits); False forces the global evaluation; a tuple is a
    precomputed ``partition_tape`` result taken as it is (the empty tuple
    means global). Raises ValueError past the kernel's limits: more than
    ``MAX_LEAVES`` leaves or a stack deeper than ``MAX_STACK``. The
    ``ClusterTree`` is built here too, from the leaves read on the host (a
    tape on the card is copied once).
    """
    if tape.k < 1:
        raise ValueError(f"interval capacity k must be >= 1, got {tape.k}")
    if tape.n_leaves > MAX_LEAVES:
        raise ValueError(f"tape has {tape.n_leaves} leaves; the kernel takes at most {MAX_LEAVES}")
    if tape.stack_depth > MAX_STACK:
        raise ValueError(f"tape stack depth {tape.stack_depth} exceeds the kernel's {MAX_STACK}")
    with profiling.span("scene.pack"):
        if isinstance(partition, tuple):
            clusters = partition or None
        elif partition in ("auto", True):
            clusters = partition_tape(tape)
            if partition is True and clusters is None:
                raise ValueError("partition=True but the tape has no disjoint union operands to cluster")
        elif partition is False:
            clusters = None
        else:
            raise ValueError(f"partition must be 'auto', True, False or a tuple, got {partition!r}")
        if clusters is None:
            clusters = ((tape.ops, tuple(range(tape.n_leaves))),)

        ops, table, ids = [], [], []
        for c_ops, c_leaves in clusters:
            if stack_depth(c_ops) > MAX_STACK:
                raise ValueError(f"tape stack depth {stack_depth(c_ops)} exceeds the kernel's {MAX_STACK}")
            slot = {leaf: j for j, leaf in enumerate(c_leaves)}
            table.append((len(ops), len(c_ops), len(ids), len(c_leaves)))
            ops += [opc | (slot[arg] << 2) if opc == OP_PUSH else opc for opc, arg in c_ops]
            ids += list(c_leaves)

        dev = tape.device

        def i32(x):
            return torch.tensor(x, dtype=torch.int32, device=dev)

        _, lamp_ids = extract_tape_lights(tape, return_ids=True)
        packed = PackedTape(
            tape=tape,
            clusters=tuple((tuple(o), tuple(ls)) for o, ls in clusters),
            leaf_table=_leaf_table(tape),
            leaf_types=i32(list(tape.leaf_types)),
            ops=i32(ops),
            cluster_table=i32(table).reshape(len(table), 4),
            leaf_ids=i32(ids),
            lamp_ids=i32(lamp_ids.tolist()) if lamp_ids.size else None,
            list_ops=i32([opc | (arg << 2) if opc == OP_PUSH else opc for opc, arg in tape.ops]),
            tables=torch.zeros(0, dtype=torch.float32, device=dev),
            tree=cluster_tree(tape, clusters) if len(clusters) > 1 else None,
        )
        return dataclasses.replace(packed, tables=_tables(packed))


# ---------------------------------------------------------------------------
# The plain torch version: the same float operations as the kernel
# ---------------------------------------------------------------------------


def _by_type(packed: PackedTape):
    """(leaf type, leaf ids, their leaf-table rows [Lt, 16]) per type present."""
    types = packed.tape.leaf_types
    for kind in sorted(set(types)):
        idx = [i for i, t in enumerate(types) if t == kind]
        yield kind, idx, packed.leaf_table[idx]


def _leaf_intervals(packed: PackedTape, o: Tensor, d: Tensor) -> tuple[Tensor, Tensor]:
    """(enter, exit) [N, L] of every leaf along rays [N, 3]
    (``_leaf_interval``, by leaf type)."""
    enter = torch.empty((o.shape[0], packed.tape.n_leaves), dtype=torch.float32, device=o.device)
    exit_ = torch.empty_like(enter)
    for kind, idx, rows in _by_type(packed):
        q = rows[:, 0:4]
        lo = quat.rotate(q, o[:, None, :] - rows[:, 4:7])  # [N, Lt, 3]
        ld = quat.rotate(q, d[:, None, :])
        if kind == NodeType.SPHERE:
            e, x = intersect.sphere_interval(lo, ld, rows[:, 7])
        elif kind == NodeType.INFINITE_PLANAR_PARTITION:
            e, x = intersect.halfspace_interval(lo, ld, rows[:, 7:10])
        elif kind == NodeType.BOX:
            e, x = intersect.box_interval(lo, ld, rows[:, 7:10])
        else:
            e, x = intersect.cylinder_interval(lo, ld, rows[:, 7], rows[:, 8])
        enter[:, idx] = e
        exit_[:, idx] = x
    return enter, exit_


def _fold(c_ops, mem: Tensor) -> Tensor:
    """Root membership from leaf memberships mem [..., Lc] (bool), walking
    the cluster's postfix ops (PUSH operands are slots)."""
    stack = []
    for opcode, slot in c_ops:
        if opcode == OP_PUSH:
            stack.append(mem[..., slot])
            continue
        right = stack.pop()
        left = stack.pop()
        if opcode == OP_UNION:
            stack.append(left | right)
        elif opcode == OP_INTERSECT:
            stack.append(left & right)
        else:  # OP_DIFF
            stack.append(left & ~right)
    return stack[0]


def tape_hit_events(packed: PackedTape, o: Tensor, d: Tensor,
                    flips: list | None = None) -> tuple[Tensor, Tensor]:
    """Event-flip nearest surface of rays [N, 3]: (t [N], entering [N]).

    t is T_FAR where nothing flips. Candidates go cluster by cluster, and
    in each the leaves in order, enter before exit; the first strictly
    nearest candidate wins (two candidates at one t give the same tree
    values, so within a cluster a first-minimum argmin is the same rule).
    ``flips``: a list to which each cluster's nearest flip [N] (T_FAR where
    it has none) is appended, in cluster order.
    """
    enter, exit_ = _leaf_intervals(packed, o, d)
    n = o.shape[0]
    t = torch.full((n,), T_FAR, dtype=torch.float32, device=o.device)
    entering = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for c_ops, c_leaves in packed.clusters:
        own = torch.full((n,), T_FAR, dtype=torch.float32, device=o.device)
        slot = {leaf: j for j, leaf in enumerate(c_leaves)}
        local_ops = [(opc, slot[arg] if opc == OP_PUSH else 0) for opc, arg in c_ops]
        e, x = enter[:, list(c_leaves)], exit_[:, list(c_leaves)]  # [N, Lc]
        cands = torch.stack([e, x], dim=-1).reshape(n, -1)  # leaf by leaf, enter first
        lc = len(c_leaves)
        group = max(1, _PLAIN_CHUNK // max(1, n * lc))
        for g0 in range(0, 2 * lc, group):
            tj = cands[:, g0:g0 + group, None]  # [N, G, 1]
            below = _fold(local_ops, (e[:, None, :] < tj) & (x[:, None, :] >= tj))
            above = _fold(local_ops, (e[:, None, :] <= tj) & (x[:, None, :] > tj))
            tj = tj[..., 0]
            flip = (below != above) & (tj > EPS) & (tj < CUT)
            cand = torch.where(flip, tj, T_FAR)
            first = torch.argmin(cand, dim=-1, keepdim=True)  # first minimum
            best = torch.gather(cand, -1, first)[:, 0]
            better = best < t
            t = torch.where(better, best, t)
            entering = torch.where(better, torch.gather(above, -1, first)[:, 0], entering)
            own = torch.minimum(own, best)
        if flips is not None:
            flips.append(own)
    return t, entering


def _node_slabs(lo: Tensor, hi: Tensor, o: Tensor, inv: Tensor, flat: Tensor):
    """(entry, exit) [K] of boxes [K, 3] along rays [K, 3], with inv = 1/d
    and the flat axes (|d| < FLAT_DIR) as the kernel's box_slab takes them."""
    ta, tb = (lo - o) * inv, (hi - o) * inv
    inside = (lo <= o) & (o <= hi)
    near = torch.where(flat, torch.where(inside, -T_FAR, T_FAR), torch.minimum(ta, tb))
    far = torch.where(flat, torch.where(inside, T_FAR, -T_FAR), torch.maximum(ta, tb))
    return (torch.clamp(near.amax(dim=-1), min=-T_FAR),
            torch.clamp(far.amin(dim=-1), max=T_FAR))


def tree_walk(packed: PackedTape, o: Tensor, d: Tensor, flips: Tensor) -> tuple[Tensor, Tensor]:
    """(leaf intervals [N], node visits [N]), int64, of the kernel's walk of
    the cluster tree for rays [N, 3], given each cluster's nearest flip
    ``flips`` [N, C] (``tape_hit_events(flips=)``): the walk replayed on
    every ray at once, with the kernel's slab arithmetic, child order and
    prune comparison, the best flip after a cluster the lesser of the two.
    A node visit is a node taken off a ray's stack, a turn of the kernel's
    node loop."""
    tree = packed.tree
    dev, n = o.device, o.shape[0]
    size = packed.cluster_table[:, 3].to(device=dev, dtype=torch.int64)
    t = torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    for c in tree.free.tolist():
        t = torch.minimum(t, flips[:, c])
        tests += size[c]
    flat = torch.abs(d) < FLAT_DIR
    inv = 1.0 / torch.where(flat, 1.0, d)
    link = tree.link.to(torch.int64)
    stack = torch.zeros((n, TREE_STACK), dtype=torch.int64, device=dev)  # the root on each
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    while True:
        live = torch.nonzero(sp > 0)[:, 0]
        if live.numel() == 0:
            return tests, visits
        visits[live] += 1
        sp[live] -= 1
        node = stack[live, sp[live]]
        tn, tf = _node_slabs(tree.lo[node], tree.hi[node], o[live], inv[live], flat[live])
        enter = (tn <= tf) & (tf >= EPS) & (tn < t[live])
        link0, link1 = link[node, 0], link[node, 1]
        leaf = enter & (link0 < 0)
        rays, c = live[leaf], ~link0[leaf]
        t[rays] = torch.minimum(t[rays], flips[rays, c])
        tests[rays] += size[c]
        inner = enter & (link0 >= 0)
        rays, left, right = live[inner], link0[inner], link1[inner] >> 2
        back = d[rays, link1[inner] & 3] < 0.0
        stack[rays, sp[rays]] = torch.where(back, left, right)  # the far child
        stack[rays, sp[rays] + 1] = torch.where(back, right, left)
        sp[rays] += 2


def tree_candidates(packed: PackedTape, p: Tensor) -> Tensor:
    """The leaves [N, L] (bool) the kernel's attribution through the tree
    scores first at points p [N, 3]: those of the unbounded clusters and
    of every cluster whose box holds the point (a leaf node is reached iff
    its box holds it: every box above holds the box)."""
    tree = packed.tree
    leaf_nodes = torch.nonzero(tree.link[:, 0] < 0)[:, 0]
    holds = ((tree.lo[leaf_nodes] <= p[:, None]) & (p[:, None] <= tree.hi[leaf_nodes])).all(-1)
    near = torch.zeros((p.shape[0], len(packed.clusters)), dtype=torch.bool, device=p.device)
    near[:, (~tree.link[leaf_nodes, 0]).long()] = holds
    near[:, tree.free.long()] = True
    cluster_of = [0] * packed.tape.n_leaves
    for c, (_, leaves) in enumerate(packed.clusters):
        for leaf in leaves:
            cluster_of[leaf] = c
    return near[:, cluster_of]


def tree_score_counts(packed: PackedTape, p: Tensor, score: Tensor) -> Tensor:
    """The leaf scores [N] int64 the kernel's attribution through the tree
    computes at hit points p [N, 3] whose leaves score ``score`` [N, L]:
    ``tree_candidates``, and every leaf again where none of them scores
    below ``ClusterTree.score_bound``."""
    cand = tree_candidates(packed, p)
    best = torch.where(cand, score, torch.inf).amin(dim=-1)
    every = torch.where(best < packed.tree.score_bound, 0, packed.tape.n_leaves)
    return cand.sum(dim=-1) + every


def _leaf_scores(packed: PackedTape, p: Tensor) -> tuple[Tensor, Tensor]:
    """Attribution inputs at hit points p [N, 3]: score [N, L] (distance to
    each leaf's surface) and local outward normal [N, L, 3]."""
    n, n_leaves = p.shape[0], packed.tape.n_leaves
    score = torch.empty((n, n_leaves), dtype=torch.float32, device=p.device)
    normal = torch.empty((n, n_leaves, 3), dtype=torch.float32, device=p.device)
    for kind, idx, rows in _by_type(packed):
        loc = quat.rotate(rows[:, 0:4], p[:, None, :] - rows[:, 4:7])  # [N, Lt, 3]
        lx, ly, lz = loc[..., 0], loc[..., 1], loc[..., 2]
        p0, p1, p2 = rows[:, 7], rows[:, 8], rows[:, 9]
        if kind == NodeType.SPHERE:
            rad = vec.sqrt(vec.dot(loc, loc))
            s = torch.abs(rad - p0)
            nl = loc * (1.0 / torch.clamp(rad, min=1e-12))[..., None]
        elif kind == NodeType.INFINITE_PLANAR_PARTITION:
            s = torch.abs(lx * p0 + ly * p1 + lz * p2)
            nl = rows[:, 7:10].expand(n, -1, -1)
        elif kind == NodeType.BOX:
            gx, gy, gz = p0 - torch.abs(lx), p1 - torch.abs(ly), p2 - torch.abs(lz)
            mx, my, mz = (torch.clamp(-g, min=0.0) for g in (gx, gy, gz))
            outside = vec.sqrt(mx * mx + my * my + mz * mz)
            inside = torch.clamp(torch.maximum(-gx, torch.maximum(-gy, -gz)), max=0.0)
            s = outside - inside
            ax, ay, az = torch.abs(gx), torch.abs(gy), torch.abs(gz)
            is_x = (ax <= ay) & (ax <= az)  # the axis with the smallest gap
            is_y = ~is_x & (ay <= az)
            sx, sy, sz = (torch.where(v >= 0.0, 1.0, -1.0) for v in (lx, ly, lz))
            nl = torch.stack([torch.where(is_x, sx, 0.0), torch.where(is_y, sy, 0.0),
                              torch.where(is_x | is_y, 0.0, sz)], dim=-1)
        else:  # cylinder
            srad = vec.sqrt(lx * lx + lz * lz)
            side = torch.abs(srad - p0)
            cap = torch.abs(torch.abs(ly) - p1)
            sqr, sqy = srad - p0, torch.abs(ly) - p1
            mr, mh = torch.clamp(sqr, min=0.0), torch.clamp(sqy, min=0.0)
            outside = vec.sqrt(mr * mr + mh * mh)
            inside = torch.clamp(torch.maximum(sqr, sqy), max=0.0)
            s = outside - inside
            inv = 1.0 / torch.clamp(srad, min=1e-12)
            use_side = side < cap
            nl = torch.stack([torch.where(use_side, lx * inv, 0.0),
                              torch.where(use_side, 0.0, torch.where(ly >= 0.0, 1.0, -1.0)),
                              torch.where(use_side, lz * inv, 0.0)], dim=-1)
        score[:, idx] = s
        normal[:, idx] = nl
    return score, normal


def tape_hit_lists(packed: PackedTape, o: Tensor, d: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The audit mode's nearest surface of rays [N, 3]: (t [N], entering
    [N], dropped [N] int32), from the whole tape's interval lists
    (``tape_eval.eval_tape_intervals``, k = ``tape.k``; t is T_FAR where
    there is no surface) and the spans its capacity dropped."""
    (t_in, t_out), dropped = tape_eval.eval_tape_intervals(packed.tape, o, d, with_dropped=True)
    t, entering, _ = interval.first_surface(t_in, t_out, eps=EPS)
    return t, entering, dropped


def tape_hit(packed: PackedTape, o: Tensor, d: Tensor, dropped: list | None = None,
             counts: dict | None = None) -> SurfaceHit:
    """The kernel's hit, as a ``SurfaceHit`` of rays [..., 3].

    The normal is the owning leaf's, face-forwarded by ``dot(d, n) > 0``;
    ``front_face`` is the solid-level ``entering`` flag. ``dropped``: a
    list given for the audit mode, which takes t and ``entering`` from the
    interval lists (``tape_hit_lists``) and appends the rays' dropped-span
    total (int64 tensor); without it, the event flip. ``counts``: a dict to
    which the leaf intervals, node visits and leaf scores the kernel's
    walks of the packed cluster tree compute for these rays are added
    (``"leaf_tests"``, ``"node_visits"``: ``tree_walk``; ``"leaf_scores"``:
    ``tree_score_counts``); t, ``entering`` and the owner are those of
    every cluster and leaf all the same.
    """
    batch = o.shape[:-1]
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    flips = [] if counts is not None else None
    if dropped is None:
        t, entering = tape_hit_events(packed, o, d, flips)
    else:
        t, entering, drop = tape_hit_lists(packed, o, d)
        dropped.append(drop.sum(dtype=torch.int64))
    hit = t < CUT
    t_safe = torch.where(hit, t, 1.0)
    p = o + t_safe[:, None] * d
    score, normal = _leaf_scores(packed, p)
    if counts is not None:
        flips = torch.stack(flips, dim=-1) if flips else t.new_zeros((t.shape[0], 0))
        tests, visits = tree_walk(packed, o, d, flips)
        add_count(counts, "leaf_tests", tests.sum())
        add_count(counts, "node_visits", visits.sum())
        add_count(counts, "leaf_scores", tree_score_counts(packed, p[hit], score[hit]).sum())
    owner = torch.argmin(score, dim=-1)  # first minimum: strict < in leaf order
    nl = torch.gather(normal, 1, owner[:, None, None].expand(-1, 1, 3))[:, 0]
    rows = packed.leaf_table[owner]
    nw = quat.rotate(quat.conjugate(rows[:, 0:4]), nl)  # local -> world
    sgn = torch.where(vec.dot(d, nw) > 0.0, -1.0, 1.0)
    h = SurfaceHit(
        t=t,
        hit=hit,
        normal=nw * sgn[:, None],
        front_face=entering,
        mat_kind=packed.tape.mat_kind[owner],
        albedo=rows[:, 13:16],
        mat_param=rows[:, 12],
    )
    return SurfaceHit(*(v.reshape(batch + v.shape[1:]) for v in h))


def render_image_tape_plain(
    packed: PackedTape,
    camera,
    width: int,
    height: int,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    lens: bool = False,
    sample_offset: int = 0,
    nee: bool = False,
    counts: dict | None = None,
    with_overflow: bool = False,
    rows: int | None = None,
    row_offset: int = 0,
    jitter: bool = True,
    sample_batch: int = 1,
) -> tuple[Tensor, ...]:
    """The plain torch version of the kernel, on any device. With ``nee``
    it renders with the packed lamps as ``lights=`` (a shadow ray is an
    event-flip ``tape_hit`` like any other); ``counts`` as in
    ``integrator.trace_paths``, plus the path segments' leaf intervals
    (``"leaf_tests"``: segments x leaves, what the kernel counts; where the
    kernel walks the cluster tree, ``uses_tree``, what its walks compute,
    their node visits, ``"node_visits"``, and the attribution's leaf
    scores, ``"leaf_scores"``).
    ``with_overflow``: path segments take the
    audit mode's interval lists, and the dropped spans of the segments
    traced are summed into a third result, ``over`` (int64 scalar).
    ``rows``, ``row_offset``, ``jitter`` and ``sample_batch`` as in
    ``integrator.render_image``."""
    if nee and packed.lamp_ids is None:
        raise ValueError(_NO_LAMPS)
    events = functools.partial(tape_hit, packed)
    dropped: list = []
    walks = {} if counts is not None and uses_tree(packed, nee, with_overflow) else None
    if with_overflow:
        path = functools.partial(tape_hit, packed, dropped=dropped)
    else:
        path = functools.partial(tape_hit, packed, counts=walks)
    img, rays = integrator.render_image(
        path, camera, width, height, spp=spp, max_bounces=max_bounces, seed=seed, sky=sky,
        jitter=jitter, lens=lens, sample_offset=sample_offset,
        lights=packed.lights if nee else None, counts=counts, shadow_hit_fn=events, rows=rows,
        row_offset=row_offset, sample_batch=sample_batch,
    )
    if walks is not None:
        for key in ("leaf_tests", "node_visits", "leaf_scores"):
            add_count(counts, key, torch.as_tensor(walks.get(key, 0), dtype=torch.int64,
                                                   device=rays.device))
    elif counts is not None:
        add_count(counts, "leaf_tests", rays * packed.tape.n_leaves)
    if not with_overflow:
        return img, rays
    return img, rays, torch.stack(dropped).sum() if dropped else rays.new_zeros(())


# ---------------------------------------------------------------------------
# The CUDA launch
# ---------------------------------------------------------------------------


_VP, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_ARGTYPES = (_VP, _VP) + (_I,) * 24 + (_U, _U, _I, _I, _F, _VP, _VP, _VP, _VP, _VP)


def _check_limits(lib) -> None:
    caps = (lib.csgr_tape_max_leaves(), lib.csgr_tape_max_stack(), lib.csgr_tape_max_k())
    if caps != (MAX_LEAVES, MAX_STACK, MAX_K):
        raise RuntimeError("tape_kernel.cu and tape_kernel.py disagree on the kernel's limits")


_KERNEL = build.Kernel(KERNEL_SOURCE, "csgr_tape_render", _ARGTYPES, "tape",
                       check_library=_check_limits)


def uses_tree(packed: PackedTape, nee: bool, with_overflow: bool) -> bool:
    """Whether the kernel walks the tape's cluster tree: the event flip
    without NEE on a tape that has one (the launcher's choice)."""
    return packed.tree is not None and not nee and not with_overflow


def launch_args(packed: PackedTape, cam_row, width, height, rows, row_offset, spp, max_bounces,
                seed, sample_offset, lens, sky, nee, with_overflow, out_rgb, out_rays,
                out_over, out_tests, out_stats=None) -> tuple:
    """The arguments of ``csgr_tape_render`` but the stream, after checking
    every tensor it passes (``out_rays``: rows x width + 1 int32;
    ``out_tests``: two int64, which the launch zeroes and fills;
    ``out_stats``: None, or the stats block, ``len(build.STATS_WORDS)``
    int64, which a stats launch zeroes and fills)."""
    dev = packed.device
    lay = packed.layout
    tree = packed.tree
    build.check_tensor(packed.tables, "tables", torch.float32, (lay.nbytes // 4,), dev)
    build.check_tensor(cam_row, "camera", torch.float32, (CAM_SIZE,), dev)
    build.check_tensor(out_rgb, "out_rgb", torch.float32, (rows, width, 3), dev)
    build.check_tensor(out_rays, "out_rays", torch.int32, (rows * width + 1,), dev)
    if with_overflow:
        build.check_tensor(out_over, "out_over", torch.int32, (rows, width), dev)
    build.check_tensor(out_tests, "out_tests", torch.int64, (2,), dev)
    if out_stats is not None:
        build.check_tensor(out_stats, "out_stats", torch.int64, (len(build.STATS_WORDS),), dev)
    n_lamps = packed.lamp_ids.numel() if nee else 0
    return (cam_row.data_ptr(), packed.tables.data_ptr(), lay.nbytes, lay.type_at, lay.ops_at,
            lay.ids_at, lay.cl_at, lay.lamp_at, lay.list_at if with_overflow else -1,
            lay.node_at, lay.free_at, packed.tape.n_leaves, packed.ops.numel(),
            len(packed.clusters), n_lamps, packed.list_ops.numel(),
            0 if tree is None else tree.lo.shape[0], 0 if tree is None else tree.free.numel(),
            packed.tape.k, packed.interval_cap, width, height, rows, row_offset, spp,
            max_bounces, seed & 0xFFFFFFFF, sample_offset & 0xFFFFFFFF, int(lens),
            SKY_MODES.index(sky), 0.0 if tree is None else tree.score_bound, out_rgb.data_ptr(),
            out_rays.data_ptr(), None if out_over is None else out_over.data_ptr(),
            out_tests.data_ptr(), None if out_stats is None else out_stats.data_ptr())


def _launch(packed: PackedTape, cam_row, width, height, spp, max_bounces, seed, sample_offset,
            lens, sky, nee, with_overflow, rows=None, row_offset=0, counts=None):
    """Launch the kernel. It counts its path segments' leaf intervals
    into a device word, which ``counts`` (a dict) takes under
    ``"leaf_tests"``, added to what it holds there, and through the cluster
    tree its attribution's leaf scores into a second, ``"leaf_scores"``.
    A launch of the event flip without NEE at cap 8 that is given
    ``counts`` runs the stats instantiation where ``build.stats_launch()``
    says so, and ``counts`` takes its block under ``"stats"`` (the segment
    word, and through the tree the walk's two words too)."""
    global LAUNCHES
    rows = height if rows is None else rows
    dev = packed.device
    _KERNEL.require_cuda(dev)
    out_over = (torch.empty((rows, width), dtype=torch.int32, device=dev) if with_overflow
                else None)
    out_rgb = torch.empty((rows, width, 3), dtype=torch.float32, device=dev)
    out_rays = torch.empty(rows * width + 1, dtype=torch.int32, device=dev)  # + the work counter
    # the launch zeroes them, then counts into them (int64: the kernel's
    # uint64 words, far from their sign bits)
    tests = torch.empty(2, dtype=torch.int64, device=dev)
    tree = uses_tree(packed, nee, with_overflow)
    stats = (torch.empty(len(build.STATS_WORDS), dtype=torch.int64, device=dev)
             if counts is not None and not nee and not with_overflow
             and packed.interval_cap == 8 and build.stats_launch() else None)
    _KERNEL(dev, *launch_args(packed, cam_row, width, height, rows, row_offset, spp, max_bounces,
                              seed, sample_offset, lens, sky, nee, with_overflow, out_rgb,
                              out_rays, out_over, tests, stats))
    LAUNCHES += 1
    mode = "audit" if with_overflow else packed.mode
    LAUNCHES_BY_MODE[mode + ("-nee" if nee else "")] += 1
    LAUNCHES_BY_SEARCH["tree" if tree else "flat"] += 1
    if counts is not None:
        add_count(counts, "leaf_tests", tests[0])
        if tree:
            add_count(counts, "leaf_scores", tests[1])
    if stats is not None:
        add_count(counts, "stats", stats[:3] if tree else stats[:1])
    rays = out_rays[:-1].sum(dtype=torch.int64)
    if with_overflow:
        return out_rgb, rays, out_over.sum(dtype=torch.int64)
    return out_rgb, rays


def render_image_tape_kernel(
    tape: CompiledTape | PackedTape,
    camera,
    width: int,
    height: int,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    jitter: bool = True,
    lens: bool = False,
    sample_offset: int = 0,
    with_overflow: bool = False,
    nee: bool = False,
    partition: bool | str | tuple = "auto",
    rows: int | None = None,
    row_offset: int = 0,
    counts: dict | None = None,
) -> tuple[Tensor, ...]:
    """Drop-in for ``integrator.render_image`` on a CSG tape.

    Returns (image [H, W, 3] f32, rays traced as an int64 scalar tensor),
    and with ``with_overflow`` a third result: the spans the tape's k-slot
    interval lists dropped over every traced segment, an int64 scalar
    tensor (0: every evaluation was exact). That audit evaluates the whole
    tape's lists (the clusters only serve NEE's shadow rays) and takes
    ``tape.k`` up to ``MAX_K``.
    ``tape`` may be a ``PackedTape`` from ``pack_program`` (packed once,
    e.g. by a benchmark; its clusters were fixed then), and ``partition``
    must then be "auto". Tape and camera tensors on a CUDA device launch
    the kernel; on the CPU they run the plain version; there is no fallback
    between the two. ``nee`` samples the emissive sphere leaves at every
    Lambertian and glossy hit (ValueError if the tape has none).
    ``rows``/``row_offset`` and ``jitter`` as in
    ``megakernel.render_image_kernel``: a full-width slab of the frame, and
    pixel centres on the CPU only. ``counts``: a dict to which the frame's
    path-segment leaf intervals are added under ``"leaf_tests"`` as an
    int64 tensor (on the card a device word the launch fills: nothing
    waits), where the kernel walks the cluster tree (``uses_tree``) its
    attribution's leaf scores under ``"leaf_scores"``, a stats launch's
    block under ``"stats"`` (see ``_launch``), and on the CPU every key of
    ``render_image_tape_plain``'s counts. Shadow rays' intervals are never
    part of ``"leaf_tests"``.
    """
    if sky not in SKY_MODES:
        raise ValueError(f"unknown sky mode {sky!r}")
    if spp < 1 or max_bounces < 0 or width < 1 or height < 1:
        raise ValueError(f"bad frame {width}x{height} spp={spp} bounces={max_bounces}")
    if isinstance(tape, PackedTape):
        if partition != "auto":
            raise ValueError("partition is fixed when the tape is already packed")
        packed = tape
    else:
        packed = pack_program(tape, partition)
    if nee and packed.lamp_ids is None:
        raise ValueError(_NO_LAMPS)
    if with_overflow and packed.tape.k > MAX_K:
        raise ValueError(f"tape k = {packed.tape.k}: the audit mode takes at most {MAX_K} slots")
    rows = integrator.slab_rows(height, rows, row_offset)
    if packed.device.type == "cpu":
        return render_image_tape_plain(
            packed, camera, width, height, spp=spp, max_bounces=max_bounces,
            seed=seed, sky=sky, lens=lens, sample_offset=sample_offset, nee=nee,
            counts=counts, with_overflow=with_overflow, rows=rows, row_offset=row_offset,
            jitter=jitter,
        )
    if not jitter:
        raise NotImplementedError(JITTER_ON_CPU_ONLY)
    return _launch(
        packed, pack_camera(camera).contiguous(), width, height, spp, max_bounces, int(seed),
        int(sample_offset), lens, sky, nee, with_overflow, rows, int(row_offset), counts=counts,
    )
