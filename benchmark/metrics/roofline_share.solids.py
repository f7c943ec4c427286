"""The tape kernel's share of its roofline in the traced window of the
many-solids cell: each frame's floor (``roofline_solids.solids_frame`` of
its segments, published H100 peaks) over the device time of
``tape_kernel``, in %."""

from benchmark import roofline, roofline_solids


def read(run):
    if run.summary is None or not run.frames or any(r is None for _, r in run.frames):
        return None
    mix, work = run.mix, run.work()
    pixels, spp = mix["width"] * mix["height"], mix["spp"]
    floor = sum(roofline.floor_seconds(*roofline_solids.solids_frame(
        r, pixels, spp, work["leaves"], work["leaf_types"], run.config["sky"]))[0]
        for _, r in run.frames)
    return roofline.share_percent(floor, run.summary.kernel_seconds("tape_kernel"))
