"""Disjoint-cluster decomposition of CSG tapes — spatial acceleration for
many-object scenes.

A copy of ``csgrenderer_tpu/scene/partition.py`` (numpy only), kept here
so that this package runs without the JAX package. The tape's tensors are
read through ``.detach().cpu().numpy()``: on a CUDA tape that is one
device-to-host copy, so the kernel's packer (``kernels/tape_kernel.py::
pack_program``) calls this once per tape, never inside a frame.

The event-flip evaluator (kernels/tape_kernel.py) is O(L^2) in leaf count:
every leaf boundary is membership-tested against every leaf. The common
authoring pattern for big CSG scenes, though, is a UNION of many small
solids (the reference's own demo unions two spheres,
``src/wololo_demo/main.c:40-45``), and for a union the nearest
surface decomposes:

    flip_t(union of A, B) = min(flip_t(A), flip_t(B))
    when A and B are spatially disjoint

— a boundary of A flips the union's membership iff it flips A's and the
point is outside B, which disjointness guarantees. So: flatten the root's
union chain into operand subtrees, bound each with a world AABB
(host-side, conservative), merge operands whose bounds PENETRATE into
clusters (connected components — overlapping solids are evaluated jointly,
keeping the decomposition EXACT), and let the kernel run the event-flip
per cluster: O(sum L_c^2) instead of O(L^2). ~100 leaves in ~3-leaf
objects is ~30x less flip work.

Tangency tolerance: bounds touching within ``margin`` (relative to the
scene scale) count as disjoint — solids RESTING on each other or on the
ground plane are UNREACHABLE at the contact set by any ray when both
sides are opaque (the contact region is interior to the union; a ray
would have to pass through a surface to reach it), so the decomposition
stays exact there up to silhouette-class rim ulps. The exception is TRANSMISSIVE solids: a
dielectric leaf lets refracted rays reach a coplanar contact face from
inside (e.g. a glass cylinder whose bottom cap rests exactly on the
ground plane — the global evaluation sees no surface there, a clustered
one would invent it), so any operand containing a dielectric leaf
merges on contact-within-margin instead of separating. Pass
``margin=None`` to require strict separation for the opaque rule too.

Unbounded leaves (infinite planar partitions) get special handling: a
half-space operand penetrates another operand iff that operand's AABB
dips beyond the plane by more than the margin — objects resting ON the
ground stay separate clusters, objects sunk INTO it merge with it.

Everything here is host-side numpy on concrete tape arrays (like the
packers); the cluster tuple is hashable, and the CUDA kernel takes it as
data (an op table and a cluster table), so a new clustering costs no
build.
"""

from __future__ import annotations

import numpy as np

from ..scene.graph import NodeType
from .tape import OP_INTERSECT, OP_PUSH, OP_UNION


def _build_tree(ops):
    """Postfix ops -> nested tuples (op, children, span_start, span_end).
    A subtree's ops are the contiguous slice [span_start, span_end)."""
    stack = []
    for i, (op, operand) in enumerate(ops):
        if op == OP_PUSH:
            stack.append((op, operand, i, i + 1))
        else:
            right = stack.pop()
            left = stack.pop()
            stack.append((op, (left, right), left[2], i + 1))
    assert len(stack) == 1, "malformed tape"
    return stack[0]


def _union_operands(node, out):
    if node[0] == OP_UNION:
        left, right = node[1]
        _union_operands(left, out)
        _union_operands(right, out)
    else:
        out.append(node)


def _subtree_leaves(ops_slice):
    return tuple(
        operand for op, operand in ops_slice if op == OP_PUSH
    )


def _quat_to_mat(q):
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix (numpy)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _leaf_aabb(ltype, pos, rot_wl, params):
    """World AABB (lo, hi) of one leaf solid, or None if unbounded.

    ``rot_wl`` is the tape's world->local quaternion; the local->world
    rotation is its conjugate. AABB of a rotated box: half-extent
    |R| @ he (componentwise absolute rotation matrix).
    """
    if ltype == NodeType.SPHERE:
        r = abs(float(params[0]))
        return pos - r, pos + r
    if ltype == NodeType.BOX:
        w, x, y, z = rot_wl
        rm = _quat_to_mat((w, -x, -y, -z))  # local -> world
        he = np.abs(rm) @ np.abs(np.asarray(params[:3], np.float64))
        return pos - he, pos + he
    if ltype == NodeType.CYLINDER:
        # tight AABB of a rotated y-axis cylinder: extent along world
        # axis i = r * |(R[i,0], R[i,2])| + hh * |R[i,1]|
        w, x, y, z = rot_wl
        rm = _quat_to_mat((w, -x, -y, -z))  # local -> world
        r, hh = float(abs(params[0])), float(abs(params[1]))
        ext = r * np.hypot(rm[:, 0], rm[:, 2]) + hh * np.abs(rm[:, 1])
        return pos - ext, pos + ext
    return None  # infinite planar partition


def _merge_aabb(a, b):
    if a is None or b is None:
        return None
    return np.minimum(a[0], b[0]), np.maximum(a[1], b[1])


def _operand_bound(ops_slice, tape_np):
    """Conservative world AABB of a subtree's solid, or None (unbounded).

    union: AABB merge; intersection: the smaller operand's AABB (any
    operand bounds the result); difference: the left operand's AABB.
    Returns (aabb_or_None, planes): ``planes`` lists (normal, offset)
    half-spaces that appear in a role that can make the SOLID unbounded
    (a plane pushed positively). Each plane is the world half-space
    {p : n . p <= o} of the leaf.
    """
    leaf_types, leaf_pos, leaf_rot, leaf_params = tape_np
    stack = []
    for op, operand in ops_slice:
        if op == OP_PUSH:
            lt = NodeType(leaf_types[operand])
            pos = leaf_pos[operand]
            box = _leaf_aabb(lt, pos, leaf_rot[operand],
                             leaf_params[operand])
            stack.append(box)
        elif op == OP_UNION:
            right = stack.pop()
            left = stack.pop()
            stack.append(_merge_aabb(left, right))
        else:  # INTERSECT or DIFF
            right = stack.pop()
            left = stack.pop()
            if op == OP_INTERSECT:  # either bound works; keep tighter
                if left is None:
                    stack.append(right)
                elif right is None:
                    stack.append(left)
                else:
                    lo = np.maximum(left[0], right[0])
                    hi = np.minimum(left[1], right[1])
                    stack.append((lo, np.maximum(hi, lo)))
            else:  # OP_DIFF: bounded by the left operand
                stack.append(left)
    return stack[0]


def _plane_halfspace(tape_np, leaf):
    """World half-space (n_world, offset) of a planar-partition leaf:
    solid = {p : n . (p - pos) <= 0} in the leaf frame -> world."""
    leaf_types, leaf_pos, leaf_rot, leaf_params = tape_np
    n_local = np.asarray(leaf_params[leaf][:3], np.float64)
    w, x, y, z = leaf_rot[leaf]
    rm = _quat_to_mat((w, -x, -y, -z))  # local -> world
    n_world = rm @ n_local
    return n_world, float(n_world @ leaf_pos[leaf])


def _host(x) -> np.ndarray:
    """A tape tensor (on any device) or array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def leaf_bounds(tape) -> list:
    """World AABB (lo, hi) of each of ``tape``'s leaves (``_leaf_aabb``,
    float64), None for an unbounded one (a half-space)."""
    pos = _host(tape.leaf_pos).astype(np.float64)
    rot = _host(tape.leaf_rot).astype(np.float64)
    params = _host(tape.leaf_params).astype(np.float64)
    return [_leaf_aabb(NodeType(kind), pos[i], rot[i], params[i])
            for i, kind in enumerate(tape.leaf_types)]


def _aabb_overlaps(a, b, tol):
    return bool(np.all(a[0] - tol <= b[1]) and np.all(b[0] - tol <= a[1]))


def _aabb_dips_below_plane(aabb, n, off, tol):
    """Does the AABB penetrate the half-space {n.p <= off} by > tol?
    Support point = the corner minimizing n.p."""
    lo, hi = aabb
    support = np.where(n >= 0, lo, hi)
    return float(n @ support) < off - tol


def partition_tape(tape, margin: float | None = "auto"):
    """Cluster ``tape``'s top-level union operands by bound overlap.

    Returns a hashable tuple of clusters, each
    ``(ops_tuple, leaf_ids_tuple)``, or None when decomposition cannot
    help (fewer than 2 clusters). ``margin``: tangency tolerance as an
    absolute distance ("auto" = 1e-4 x scene diagonal; None = 0).
    """
    ops = tuple(tape.ops)
    tree = _build_tree(ops)
    operands: list = []
    _union_operands(tree, operands)
    if len(operands) < 2:
        return None

    leaf_types = tuple(tape.leaf_types)
    leaf_pos = _host(tape.leaf_pos).astype(np.float64)
    leaf_rot = _host(tape.leaf_rot).astype(np.float64)
    leaf_params = _host(tape.leaf_params).astype(np.float64)
    tape_np = (leaf_types, leaf_pos, leaf_rot, leaf_params)

    slices = [ops[nd[2]:nd[3]] for nd in operands]
    bounds = [_operand_bound(s, tape_np) for s in slices]

    if margin == "auto":
        finite = [b for b in bounds if b is not None]
        if finite:
            lo = np.min([b[0] for b in finite], axis=0)
            hi = np.max([b[1] for b in finite], axis=0)
            margin = 1e-4 * float(np.linalg.norm(hi - lo))
        else:
            margin = 0.0
    tol = float(margin or 0.0)

    # half-space footprint per operand: any planar leaf anywhere in the
    # subtree can unbound it; collect the planes for the dip test
    op_planes = []
    op_diel = []
    mat_kind = _host(tape.mat_kind)
    for s in slices:
        planes = [
            _plane_halfspace(tape_np, operand)
            for op, operand in s
            if op == OP_PUSH
            and NodeType(leaf_types[operand])
            == NodeType.INFINITE_PLANAR_PARTITION
        ]
        op_planes.append(planes)
        # transmissive operands (any dielectric leaf) merge on CONTACT,
        # not just penetration: refracted rays reach coplanar contact
        # faces from inside, where the min decomposition would invent a
        # surface the global evaluation does not have (see module doc)
        op_diel.append(any(
            mat_kind[operand] == 3
            for op, operand in s if op == OP_PUSH
        ))

    n = len(operands)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        parent[find(i)] = find(j)

    for i in range(n):
        for j in range(i + 1, n):
            bi, bj = bounds[i], bounds[j]
            # dielectric pairs flip the tolerance sign: contact within
            # tol merges (transmission exposes the contact set) instead
            # of requiring penetration beyond tol
            pair_tol = tol if (op_diel[i] or op_diel[j]) else -tol
            if bi is None and bj is None:
                union(i, j)  # two unbounded operands: evaluate jointly
                continue
            if bi is None or bj is None:
                unb, box = (i, bj) if bi is None else (j, bi)
                # penetrates iff the box dips beyond any of the
                # unbounded operand's half-spaces by more than tol;
                # an unbounded operand with NO planar leaf (shouldn't
                # happen) merges conservatively
                planes = op_planes[unb]
                if not planes or any(
                    _aabb_dips_below_plane(box, nrm, off, -pair_tol)
                    for nrm, off in planes
                ):
                    union(i, j)
                continue
            if _aabb_overlaps(bi, bj, pair_tol):
                union(i, j)

    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    if len(groups) < 2:
        return None

    clusters = []
    for members in groups.values():
        c_ops: list = []
        c_leaves: list = []
        for m in sorted(members):
            c_ops.extend(slices[m])
            c_leaves.extend(_subtree_leaves(slices[m]))
            if m != sorted(members)[0]:
                c_ops.append((OP_UNION, 0))
        clusters.append((tuple(c_ops), tuple(c_leaves)))
    # deterministic order: by smallest leaf id
    clusters.sort(key=lambda c: min(c[1]))
    return tuple(clusters)
