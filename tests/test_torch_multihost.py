"""Two OS processes, one gloo world: tests/test_multihost.py's mirror.

Two processes (this file, run as a script, is the child) join through
``parallel.initialize_multihost`` on a free localhost port, one rank each,
and render one 32x16, 2-spp, 4-bounce frame (seed 3) over a 2x1 mesh, an
8-row slab per rank: through ``render_image_sharded`` with the scene's hit
function (JAX's ``backend="jnp"`` route, which tests/test_multihost.py's
child takes) and through ``render_scene_sharded`` (the kernel wrapper's
plain version). JAX's test has two processes of two devices at 4x1; here
a process is a rank. The parent asserts that both ranks read the same ray
count, equal to JAX's ``integrator.render_image`` count, and that every
slab is bit-identical to the port's single-process image. Each child is
given a time limit (``communicate(timeout=...)``), so a hang fails the
test rather than stalling the suite. The child imports nothing of JAX.

    python tests/test_torch_multihost.py <rank> <port>

prints one line per path: ``<PATH> RAYS <n> SHARD <row0>:<sha256>``.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
FRAME = dict(width=32, height=16, spp=2, max_bounces=4, seed=3)


def _scene_and_camera():
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.models import two_spheres_scene

    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0)
    return two_spheres_scene(), cam


def _sha(slab) -> str:
    return hashlib.sha256(np.ascontiguousarray(slab.numpy(), np.float32).tobytes()).hexdigest()


def child(rank: int, port: str) -> int:
    import torch
    import torch.distributed as dist

    from csgrenderer_tpu_torch.parallel import (
        initialize_multihost,
        make_mesh,
        render_image_sharded,
        render_scene_sharded,
    )

    torch.set_num_threads(1)
    for _ in range(2):  # the second call is a no-op
        initialize_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=rank)
    assert dist.get_world_size() == 2 and dist.get_rank() == rank
    mesh = make_mesh(2, 1, device="cpu")  # rows over both processes
    assert mesh.index == (rank, 0)
    scene, cam = _scene_and_camera()
    w, h = FRAME["width"], FRAME["height"]
    kw = {k: v for k, v in FRAME.items() if k not in ("width", "height")}
    for path, (slab, rays) in (
        ("IMAGE", render_image_sharded(scene.nearest_hit, cam, w, h, mesh, **kw)),
        ("SCENE", render_scene_sharded(scene, cam, w, h, mesh, **kw)),
    ):
        row0 = rank * (h // 2)
        print(f"{path} RAYS {int(rays)} SHARD {row0}:{_sha(slab)}", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def test_two_process_sharded_render_matches_single_process():
    from csgrenderer_tpu_torch.parallel.launch import free_port

    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = [
        subprocess.Popen([sys.executable, __file__, str(rank), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for rank in range(2)
    ]
    lines = {}
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"child {rank} failed:\n{out}\n{err}"
            for line in out.splitlines():
                path, _, rays, _, shard = line.split()
                lines.setdefault(path, []).append((int(rays), shard))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert sorted(lines) == ["IMAGE", "SCENE"]

    from csgrenderer_tpu.camera import Camera as JCamera
    from csgrenderer_tpu.models import two_spheres_scene as j_two
    from csgrenderer_tpu.render import integrator as j_integrator
    from csgrenderer_tpu_torch.render import integrator

    scene, cam = _scene_and_camera()
    ref, rays = integrator.render_image(scene.nearest_hit, cam, **FRAME)
    jcam = JCamera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0)
    _, j_rays = j_integrator.render_image(j_two().nearest_hit, jcam, **FRAME)
    assert int(rays) == int(j_rays)
    want = {f"{row0}:{_sha(ref[row0:row0 + 8])}" for row0 in (0, 8)}
    for path, got in lines.items():
        assert [r for r, _ in got] == [int(rays)] * 2, path  # both ranks read the total
        assert {shard for _, shard in got} == want, path  # every slab bit-identical


if __name__ == "__main__":
    sys.exit(child(int(sys.argv[1]), sys.argv[2]))
