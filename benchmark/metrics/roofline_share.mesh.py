"""The mesh kernel's share of its roofline in the traced window: each
frame's floor (``roofline_mesh.mesh_frame`` of its segments, published H100
peaks) over the device time of ``trimesh_kernel``, in %."""

from benchmark import roofline, roofline_mesh


def read(run):
    if run.summary is None or not run.frames or any(r is None for _, r in run.frames):
        return None
    mix = run.mix
    pixels, spp, faces = mix["width"] * mix["height"], mix["spp"], run.work()["faces"]
    floor = sum(roofline.floor_seconds(*roofline_mesh.mesh_frame(
        r, pixels, spp, faces, run.config["sky"]))[0] for _, r in run.frames)
    return roofline.share_percent(floor, run.summary.kernel_seconds("trimesh_kernel"))
