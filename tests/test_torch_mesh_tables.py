"""The staged tables of the mesh and tape kernels, on the CPU: no card, no
nvcc.

The mesh packer's MT table ([F, 3] float4: v0, e1, e2, what a
Möller-Trumbore test reads), the block of tables the kernel stages in shared
memory when it fits (its size for the 966-face meshnight scene and the
15,362-face bench mesh), and the launcher's staged-or-global choice by
that size, seen through a stand-in for the ctypes call. The tape packer's
block of tables (every section equal to its tensor) and the interval-array
cap the launcher picks from the largest cluster of the bench tapes; a
tape of more than 256 leaves is still refused.
"""

import pytest
import torch

from csgrenderer_tpu_torch.kernels import megakernel as mk
from csgrenderer_tpu_torch.kernels import tape_kernel as tk
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
from csgrenderer_tpu_torch.models import (
    animated_csg_scene,
    csg_night_scene,
    many_objects_scene,
    mesh_demo_scene,
    mesh_night_scene,
)

H100_LIMIT = 232_448 - 16  # opt-in shared memory per block less the kernel's mbarrier

MESHES = {
    "meshnight": (lambda: mesh_night_scene(), "auto", 64_960),
    "bench-mesh": (lambda: mesh_demo_scene(4), "auto", 1_251_952),
    "brute": (lambda: mesh_demo_scene(1), False, 242 * 48),
}


@pytest.fixture(scope="module")
def packed_meshes():
    return {name: tm.pack_mesh(make(), worklist) for name, (make, worklist, _) in MESHES.items()}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mt_table(packed_meshes, name):
    """The MT table is the face table's columns 0-8 (v0, e1, e2) and a zero
    pad word, contiguous, at a 16-byte aligned address, 48 bytes a face, at
    the head of the staged block."""
    packed = packed_meshes[name]
    f = packed.mesh.num_faces
    mt = packed.mt
    assert mt.shape == (f, tm.MT_WORDS) and mt.dtype == torch.float32 and mt.is_contiguous()
    assert mt.data_ptr() % 16 == 0 and mt.data_ptr() == packed.tables.data_ptr()
    assert torch.equal(mt[:, :9], packed.faces[:, :9])
    assert torch.equal(mt[:, 9:], torch.zeros(f, 3))
    assert torch.equal(mt[:, 0:3], packed.mesh.v0) and torch.equal(mt[:, 6:9], packed.mesh.e2)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_staged_block_size(packed_meshes, name):
    """The block is F x 48 bytes, then (grid) the offsets, face ids and
    globals each padded to 16 bytes: 64,960 bytes for meshnight, which a
    CTA stages on an H100, and 1,251,952 for the 15,362-face bench mesh,
    which it cannot; every section holds its tensor."""
    packed = packed_meshes[name]
    lay = packed.layout
    f = packed.mesh.num_faces
    expect = MESHES[name][2]
    assert packed.table_bytes == lay.nbytes == expect and expect % 16 == 0
    assert (expect <= H100_LIMIT) == (name != "bench-mesh")
    if packed.grid is None:
        assert lay[:3] == (-1, -1, -1) and expect == f * 48
        return
    g = packed.grid
    pad = lambda n: (4 * n + 15) // 16 * 16  # noqa: E731
    assert lay.off_at == f * 48
    assert lay.ids_at == lay.off_at + pad(g.offsets.numel())
    assert lay.glob_at == lay.ids_at + pad(g.face_ids.numel())
    assert lay.nbytes == lay.glob_at + pad(g.n_globals)
    words = packed.tables.view(torch.int32)
    for at, t in ((lay.off_at, g.offsets), (lay.ids_at, g.face_ids), (lay.glob_at, g.globals_idx)):
        assert torch.equal(words[at // 4:at // 4 + t.numel()], t)
    moved = packed.to("meta")
    assert moved.tables.shape == packed.tables.shape and moved.tables.device.type == "meta"


class _Recorder:
    """Stands in for the mesh wrapper's ``build.Kernel``: records each
    launch's arguments."""

    def __init__(self):
        self.calls = []

    def require_cuda(self, device):
        pass

    def __call__(self, device, *args):
        self.calls.append(args)


@pytest.mark.parametrize("limit", [H100_LIMIT, 48 * 1024])
def test_staged_or_global_by_size(monkeypatch, packed_meshes, limit):
    """The launcher stages the tables when they fit the device's limit
    (its shared_tables argument 1, counted "shared"), else reads them from
    global memory (0, "global"); force_global reads global memory whatever
    the size. meshnight's 64,960 bytes fit an H100's limit, not 48 KB."""
    rec = _Recorder()
    monkeypatch.setattr(tm, "_KERNEL", rec)
    monkeypatch.setattr(tm, "table_limit", lambda index: limit)
    cam = torch.zeros(mk.CAM_SIZE)
    before = dict(tm.LAUNCHES_BY_TABLES)
    # ..., lens, sky, shared_tables, out_rgb, out_rays, out_tests, out_stats
    shared_arg = len(tm._ARGTYPES) - 5
    expect = []
    for name in ("meshnight", "bench-mesh", "brute"):
        packed = packed_meshes[name]
        for force in (False, True):
            img, rays = tm._launch(packed, cam, 16, 8, 1, 2, 0, 0, False, "black",
                                   name == "meshnight", force_global=force)
            assert img.shape == (8, 16, 3) and rays.dtype == torch.int64
            expect.append(int(not force and packed.table_bytes <= limit))
    got = [args[shared_arg] for args in rec.calls]
    assert len(rec.calls[0]) == len(tm._ARGTYPES)
    assert got == expect and got[0] == int(limit == H100_LIMIT) and got[2] == 0
    staged = sum(expect)
    assert tm.LAUNCHES_BY_TABLES == {"shared": before["shared"] + staged,
                                     "global": before["global"] + len(expect) - staged}


def _deepcsg():
    graph, animate = animated_csg_scene(8)
    return animate(graph.compile(k=4), 1.0)


TAPES = {  # tape, partition, largest cluster, cap
    "deepcsg-clustered": (_deepcsg, "auto", 6, 8),
    "deepcsg-global": (_deepcsg, False, 8, 8),
    "csgnight-clustered": (lambda: csg_night_scene().compile(k=4), "auto", 3, 8),
    "csgnight-global": (lambda: csg_night_scene().compile(k=4), False, 9, 32),
    "manyobjects-clustered": (lambda: many_objects_scene(99).compile(k=4), "auto", 2, 8),
    "manyobjects-global": (lambda: many_objects_scene(99).compile(k=4), False, 199, 256),
}


@pytest.mark.parametrize("name", sorted(TAPES))
def test_tape_interval_cap(name):
    """The launcher's interval arrays are the smallest of 8, 32 and 256
    slots that hold the tape's largest cluster."""
    make, partition, largest, cap = TAPES[name]
    packed = tk.pack_program(make(), partition)
    assert max(len(leaves) for _, leaves in packed.clusters) == largest
    assert packed.interval_cap == cap and cap in tk.INTERVAL_CAPS


@pytest.mark.parametrize("name", sorted(TAPES))
def test_tape_staged_block(name):
    """Every section of the tape's staged block holds its tensor, at a
    16-byte aligned offset (the 99-object scene's cluster tree too); the
    block is a multiple of 16 bytes."""
    make, partition, _, _ = TAPES[name]
    packed = tk.pack_program(make(), partition)
    lay = packed.layout
    assert packed.table_bytes == lay.nbytes and lay.nbytes % 16 == 0
    assert all(at % 16 == 0 for at in lay) and packed.tables.data_ptr() % 16 == 0
    n_leaf_words = packed.leaf_table.numel()
    assert torch.equal(packed.tables[:n_leaf_words].view_as(packed.leaf_table), packed.leaf_table)
    words = packed.tables.view(torch.int32)
    none = packed.leaf_types.new_zeros(0)
    lamps = none if packed.lamp_ids is None else packed.lamp_ids
    tree = packed.tree
    assert (tree is not None) == (name == "manyobjects-clustered")
    nodes, free = (none, none) if tree is None else (tree.words.reshape(-1), tree.free)
    for at, t in zip(lay[:-1], (packed.leaf_types, packed.ops, packed.leaf_ids,
                                packed.cluster_table.reshape(-1), lamps, packed.list_ops, nodes,
                                free)):
        assert torch.equal(words[at // 4:at // 4 + t.numel()], t)
    assert lay.nbytes <= 48 * 1024  # every tape the kernel takes fits without opting in


def test_tape_over_256_leaves_refused():
    """many_objects_scene(128) has 257 leaves: the packer refuses it."""
    tape = many_objects_scene(128).compile(k=4)
    assert tape.n_leaves == 257
    with pytest.raises(ValueError, match="at most 256"):
        tk.pack_program(tape)
