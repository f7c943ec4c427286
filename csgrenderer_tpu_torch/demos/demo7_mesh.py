"""Demo 7: triangle meshes, the reference's own "later" milestone.

Twin of ``demos/demo7_mesh.py``. The reference scopes itself to CSG "with
meshes later" (README.md:1-13); this demo path-traces a triangle-mesh
scene (subdivided icospheres and a floor quad, 962 faces at subdivision
2) through the mesh kernel: its voxel-grid mode for 192 faces or more,
brute force below that or with ``--worklist off``, and with ``--nee`` the
night variant (emissive quad lamps, black sky, next-event estimation).

    python -m csgrenderer_tpu_torch.demos.demo7_mesh --out mesh.png
    python -m csgrenderer_tpu_torch.demos.demo7_mesh --obj model.obj   (render your own mesh)
"""

from __future__ import annotations

import sys

from ._common import device_of, how, single_frame, single_frame_argparser


def main(argv=None) -> int:
    ap = single_frame_argparser("demo7_mesh", width=640, height=360, spp=32, bounces=6)
    ap.add_argument("--obj", default=None, help="render an OBJ file instead")
    ap.add_argument("--subdiv", type=int, default=2,
                    help="icosphere subdivision (2 -> 962 faces, 3 -> 3842, 4 -> 15362)")
    ap.add_argument("--worklist", default="auto", choices=["auto", "off"],
                    help="the voxel grid's per-voxel face lists (auto) or brute force (off)")
    ap.add_argument("--nee", action="store_true",
                    help="night variant: emissive quad lamps, black sky, next-event estimation "
                    "toward the lamp faces with MIS")
    args = ap.parse_args(argv)
    device = device_of(args)

    from ..camera import Camera
    from ..kernels import trimesh_kernel
    from ..models import mesh_demo_scene, mesh_night_scene
    from ..scene import Material

    if args.obj:
        from ..io.obj import load_mesh

        mesh = load_mesh(args.obj, Material.lambertian((0.6, 0.6, 0.6)), device=device)
    elif args.nee:
        mesh = mesh_night_scene(args.subdiv, device=device)
    else:
        mesh = mesh_demo_scene(args.subdiv, device=device)
    sky = "black" if args.nee else "rtiow"
    cam = Camera.look_at((0.0, 1.6, 2.2), (0.0, 0.7, -2.6), vfov_degrees=45.0,
                         aspect_ratio=args.width / args.height, device=device)
    packed = trimesh_kernel.pack_mesh(mesh, worklist=False if args.worklist == "off" else "auto")
    tail = single_frame(args, device, trimesh_kernel.KERNEL_SOURCE, lambda: (
        trimesh_kernel.render_image_mesh_kernel(
            packed, cam, args.width, args.height, spp=args.spp, max_bounces=args.bounces,
            seed=7, sky=sky, nee=args.nee)))
    mode = packed.mode + ("-nee" if args.nee else "")
    print(f"[csgr] demo7: {mesh.num_faces} triangles, {args.width}x{args.height} spp={args.spp} "
          f"via {how(device, f'trimesh_kernel[{mode}]')}: {tail}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
