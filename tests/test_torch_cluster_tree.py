"""The tape kernel's cluster tree on the CPU: no card, no nvcc.

- The packer: a leaf node's box holds its cluster's leaves' AABBs widened
  by the pad, an inner node's its children's boxes; the unbounded clusters
  are exactly those holding a half-space; the tree holds every bounded
  cluster once, shallower than the kernel's stack; the staged block holds
  the nodes and the unbounded clusters. The rule of ``TREE_MIN_CLUSTERS``
  bounded clusters leaves deepcsg (config 5), config 3, csgnight and the
  4-, 8- and 12-object cuts flat, and engages from 16 objects.
- The plain version's replay of the kernel's walks (``tree_walk``: leaf
  intervals and node visits) against a one-ray-at-a-time walk written out
  here in float32, on a few hundred rays of the 99-object scene (some
  parallel to an axis); the walk keeps every cluster's nearest flip that
  could win, so its t is the flat loop's.
- The attribution: at hit points and at random points, the first minimum
  over the leaves the tree keeps (``tree_candidates``) is the first
  minimum over every leaf wherever it lies below the score bound.
- The counts of a plain frame, the launch's arguments and the renderer's
  fence.
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.app import PathTraceRenderer
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import tape_kernel as tk
from csgrenderer_tpu_torch.models import (animated_csg_scene, config3_csg_scene,
                                          csg_night_scene, many_objects_scene)
from csgrenderer_tpu_torch.render.intersect import T_FAR
from csgrenderer_tpu_torch.scene.graph import NodeType
from csgrenderer_tpu_torch.scene.partition import leaf_bounds
from csgrenderer_tpu_torch.utils.config import RenderConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _deepcsg(t=1.0):
    graph, animate = animated_csg_scene(8)
    return animate(graph.compile(k=4), t)


TAPES = {  # name -> (tape, builds a tree)
    "manyobjects4": (lambda: many_objects_scene(4).compile(k=4), False),
    "manyobjects8": (lambda: many_objects_scene(8).compile(k=4), False),
    "manyobjects12": (lambda: many_objects_scene(12).compile(k=4), False),
    "manyobjects16": (lambda: many_objects_scene(16).compile(k=4), True),
    "manyobjects99": (lambda: many_objects_scene(99).compile(k=4), True),
    "deepcsg": (_deepcsg, False),
    "config5-t0": (lambda: _deepcsg(0.0), False),
    "config3": (lambda: config3_csg_scene().compile(), False),
    "csgnight": (lambda: csg_night_scene().compile(k=4), False),
}
TREES = sorted(name for name, (_, tree) in TAPES.items() if tree)


@pytest.fixture(scope="module")
def packs():
    return {name: tk.pack_program(make()) for name, (make, _) in TAPES.items()}


@pytest.mark.parametrize("name", sorted(TAPES))
def test_the_tree_engages_from_16_bounded_clusters(packs, name):
    packed = packs[name]
    bounded = sum(all(b is not None for b in (leaf_bounds(packed.tape)[leaf] for leaf in leaves))
                  for _, leaves in packed.clusters)
    assert (packed.tree is not None) == TAPES[name][1]
    assert (packed.tree is not None) == (len(packed.clusters) > 1
                                         and bounded >= tk.TREE_MIN_CLUSTERS)
    if packed.tree is None:  # the block ends where the parent's did
        lay = packed.layout
        assert lay.node_at == lay.free_at == lay.nbytes


def _depth(link, i=0):
    if link[i, 0] < 0:
        return 1
    return 1 + max(_depth(link, int(link[i, 0])), _depth(link, int(link[i, 1]) >> 2))


@pytest.mark.parametrize("name", TREES)
def test_the_tree_bounds_every_bounded_cluster_once(packs, name):
    packed = packs[name]
    tree = packed.tree
    lo, hi, link = tree.lo.double().numpy(), tree.hi.double().numpy(), tree.link.numpy()
    bounds = leaf_bounds(packed.tape)
    free = [c for c, (_, leaves) in enumerate(packed.clusters)
            if any(packed.tape.leaf_types[leaf] == NodeType.INFINITE_PLANAR_PARTITION
                   for leaf in leaves)]
    assert tree.free.tolist() == free == [len(packed.clusters) - 1]  # the ground
    leaf_nodes = [i for i in range(len(link)) if link[i, 0] < 0]
    held = sorted(~int(link[i, 0]) for i in leaf_nodes)
    assert held == sorted(set(range(len(packed.clusters))) - set(free))
    for i in leaf_nodes:
        for leaf in packed.clusters[~int(link[i, 0])][1]:
            b_lo, b_hi = bounds[leaf]
            assert np.all(lo[i] <= b_lo - tree.pad) and np.all(b_hi + tree.pad <= hi[i])
    for i in range(len(link)):
        if link[i, 0] >= 0:
            for child in (int(link[i, 0]), int(link[i, 1]) >> 2):
                assert child > i
                assert np.all(lo[i] <= lo[child]) and np.all(hi[child] <= hi[i])
    assert len(link) == 2 * len(leaf_nodes) - 1
    assert _depth(link) < tk.TREE_STACK
    assert tree.score_bound == np.float32(tree.pad / 2)
    words = packed.tables.view(torch.int32)
    lay = packed.layout
    assert lay.node_at % 16 == 0 and lay.free_at == lay.node_at + 32 * len(link)
    assert torch.equal(words[lay.node_at // 4:lay.free_at // 4].view(-1, 8), tree.words)
    assert torch.equal(words[lay.free_at // 4:lay.free_at // 4 + len(free)], tree.free)
    assert torch.equal(tree.words[:, :3].view(torch.float32), tree.lo)
    assert torch.equal(tree.words[:, 4:7].view(torch.float32), tree.hi)


def test_a_moved_pack_keeps_its_tree(packs):
    packed = packs["manyobjects16"]
    for device in ("cpu", "meta"):
        moved = packed.to(device)
        assert moved.tree.lo.device.type == device and moved.tree.pad == packed.tree.pad
    assert torch.equal(packed.to("cpu").tree.link, packed.tree.link)


def _rays(n, seed):
    """Rays through the 99-object field: origins above and inside it,
    random directions, some along an axis (zero or tiny components)."""
    g = np.random.default_rng(seed)
    o = np.stack([g.uniform(-13, 13, n), g.uniform(0.05, 6, n), g.uniform(-13, 13, n)], 1)
    o[: n // 4] = (0.0, 7.0, 9.0)  # the cell's camera
    d = g.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1])
    axis = g.integers(0, 3, n)
    for k in range(n // 3):  # axis-parallel: exact zeros and tiny components
        d[k, axis[k]] = 0.0 if k % 2 else 1e-25
    return (torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32))


def _naive_walk(packed, o, d, flips):
    """(leaf intervals, t, node visits) of one ray's walk as the kernel's
    tree_flip does it, in float32 scalars."""
    f32 = np.float32
    tree = packed.tree
    lo, hi, link = tree.lo.numpy(), tree.hi.numpy(), tree.link.numpy()
    size = packed.cluster_table[:, 3].numpy()
    t, tests = f32(T_FAR), 0
    for c in tree.free.tolist():
        t, tests = min(t, flips[c]), tests + size[c]
    flat = [abs(x) < f32(tk.FLAT_DIR) for x in d]
    inv = [f32(1.0) / (f32(1.0) if flat[a] else d[a]) for a in range(3)]
    stack, visits = [0], 0
    while stack:
        i = stack.pop()
        visits += 1
        tn, tf = f32(-T_FAR), f32(T_FAR)
        for a in range(3):
            if flat[a]:
                inside = lo[i, a] <= o[a] <= hi[i, a]
                near, far = (f32(-T_FAR), f32(T_FAR)) if inside else (f32(T_FAR), f32(-T_FAR))
            else:
                ta, tb = (lo[i, a] - o[a]) * inv[a], (hi[i, a] - o[a]) * inv[a]
                near, far = min(ta, tb), max(ta, tb)
            tn, tf = max(tn, near), min(tf, far)
        if not (tn <= tf and tf >= f32(tk.EPS) and tn < t):
            continue
        left, right = int(link[i, 0]), int(link[i, 1])
        if left < 0:
            t, tests = min(t, flips[~left]), tests + size[~left]
            continue
        back = d[right & 3] < 0
        stack += [left, right >> 2] if back else [right >> 2, left]  # the near child on top
    return tests, t, visits


@pytest.mark.parametrize("seed", [3, 2**31 + 29])
def test_the_replayed_walk_is_one_ray_at_a_time(packs, seed):
    packed = packs["manyobjects99"]
    o, d = _rays(300, seed)
    flips = []
    t, _ = tk.tape_hit_events(packed, o, d, flips)
    flips = torch.stack(flips, dim=-1)
    assert flips.shape == (300, len(packed.clusters))
    assert torch.equal(flips.amin(dim=-1), t)
    tests, visits = tk.tree_walk(packed, o, d, flips)
    on, fn = o.numpy(), flips.numpy()
    for r, dr in enumerate(d.numpy()):
        n, t_walk, v = _naive_walk(packed, on[r], dr, fn[r])
        assert int(tests[r]) == n and int(visits[r]) == v >= 1
        assert t_walk == t[r]  # the walk skips no cluster whose flip could win
    assert int(tests.sum()) < 300 * packed.tape.n_leaves / 10


def _first_min(score):
    return torch.argmin(score, dim=-1)  # the first minimum, as the kernel's leaf order


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_the_trees_owner_is_every_leafs(packs, seed):
    """Hit points (on a surface) and random points: where the best score
    among the tree's candidates lies below the bound, its first minimum is
    the first minimum over every leaf, and every leaf left out scores
    above the bound; at hit points the bound nearly always holds."""
    packed = packs["manyobjects99"]
    o, d = _rays(600, seed)
    t, _ = tk.tape_hit_events(packed, o, d)
    hit = t < tk.CUT
    g = torch.Generator().manual_seed(seed % 2**31)
    loose = torch.rand((400, 3), generator=g) * torch.tensor([26.0, 3.0, 26.0]) - torch.tensor(
        [13.0, 0.5, 13.0])
    p = torch.cat([(o + t[:, None] * d)[hit], loose])
    score, _ = tk._leaf_scores(packed, p)
    cand = tk.tree_candidates(packed, p)
    kept = torch.where(cand, score, torch.inf)
    bound = packed.tree.score_bound
    near = kept.amin(dim=-1) < bound
    assert near[:int(hit.sum())].float().mean() > 0.99 and int(hit.sum()) > 300
    assert 0 < int(near[int(hit.sum()):].sum()) < 400  # random points: both outcomes
    assert torch.equal(_first_min(kept)[near], _first_min(score)[near])
    assert bool((score[near][~cand[near]] > bound).all())
    n_leaves = packed.tape.n_leaves
    counts = tk.tree_score_counts(packed, p, score)
    assert torch.equal(counts, cand.sum(-1) + torch.where(near, 0, n_leaves))


def _cam(width, height):
    return Camera.look_at((0, 7.0, 9.0), (0, 0.4, 0), vfov_degrees=45.0,
                          aspect_ratio=width / height)


@pytest.mark.parametrize("with_overflow", [False, True])
def test_a_plain_frame_counts_what_the_kernel_computes(packs, with_overflow):
    """Through the tree the plain version counts the walks' leaf intervals
    (fewer than leaves x segments) and the attribution's scores; the audit
    mode, which walks no tree, counts leaves x segments and no scores."""
    packed = packs["manyobjects16"]
    assert tk.uses_tree(packed, False, with_overflow) == (not with_overflow)
    counts = {}
    out = tk.render_image_tape_kernel(packed, _cam(24, 12), 24, 12, spp=1, max_bounces=4,
                                      seed=2, with_overflow=with_overflow, counts=counts)
    rays, leaves = int(out[1]), packed.tape.n_leaves
    if with_overflow:
        assert int(counts["leaf_tests"]) == rays * leaves and "leaf_scores" not in counts
    else:
        assert 0 < int(counts["leaf_tests"]) < rays * leaves / 4
        assert rays // 2 < int(counts["leaf_scores"]) < rays * leaves / 4


@pytest.mark.parametrize("name,tree", [("manyobjects16", True), ("deepcsg", False)])
def test_the_launch_passes_the_tree(packs, name, tree):
    packed = packs[name]
    lay = packed.layout
    tests = torch.zeros(2, dtype=torch.int64)
    args = tk.launch_args(packed, torch.zeros(tk.CAM_SIZE), 8, 4, 4, 0, 1, 2, 0, 0, False,
                          "rtiow", False, False, torch.zeros((4, 8, 3)),
                          torch.zeros(33, dtype=torch.int32), None, tests)
    assert len(args) == len(tk._ARGTYPES)
    assert args[9:11] == (lay.node_at, lay.free_at)
    n_nodes, n_free, score_bound = args[16], args[17], args[30]
    if tree:
        assert (n_nodes, n_free, score_bound) == (packed.tree.lo.shape[0], 1,
                                                  packed.tree.score_bound)
    else:
        assert (n_nodes, n_free, score_bound) == (0, 0, 0.0)
    with pytest.raises(ValueError, match="out_tests"):
        tk.launch_args(packed, torch.zeros(tk.CAM_SIZE), 8, 4, 4, 0, 1, 2, 0, 0, False, "rtiow",
                       False, False, torch.zeros((4, 8, 3)), torch.zeros(33, dtype=torch.int32),
                       None, torch.zeros((), dtype=torch.int64))


def test_the_renderer_reads_the_leaf_scores_at_its_fence(packs):
    frame = dict(width=16, height=8, spp=1, max_bounces=3, seed=4)
    cam = _cam(16, 8)
    r = PathTraceRenderer(many_objects_scene(16).compile(k=4), cam, RenderConfig(**frame),
                          progressive=True, device="cpu")
    r.draw_frame(0.0)
    counts = {}
    tk.render_image_tape_kernel(r._packed, cam, counts=counts, **frame)
    assert r.last_frame_leaf_tests == int(counts["leaf_tests"])
    assert r.last_frame_leaf_scores == int(counts["leaf_scores"]) > 0
    s = PathTraceRenderer(_deepcsg(), cam, RenderConfig(**frame), progressive=True, device="cpu")
    s.draw_frame(0.0)
    assert s.last_frame_leaf_scores is None and s.last_frame_leaf_tests > 0
