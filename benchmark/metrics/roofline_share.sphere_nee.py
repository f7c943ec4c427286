"""The sphere kernel's share of its roofline in the NEE cell's traced
window: each frame's floor (``roofline_nee.nee_frame``: the sphere-soup
floor of its segments plus its shadow rays' NEE operations, published H100
peaks) over the device time of ``sphere_megakernel``, in %. None where the
program reads no shadow rays back."""

from benchmark import roofline, roofline_nee


def read(run):
    shadows = run.facts.get("shadow_rays")
    if (run.summary is None or not shadows or len(shadows) != len(run.frames)
            or any(s is None for s in shadows)):
        return None
    mix, work = run.mix, run.work()
    pixels, spp = mix["width"] * mix["height"], mix["spp"]
    floor = sum(roofline.floor_seconds(*roofline_nee.nee_frame(
        r, s, pixels, spp, work["primitives"], work["lamps"], run.config["sky"]))[0]
        for (_, r), s in zip(run.frames, shadows))
    return roofline.share_percent(floor, run.summary.kernel_seconds("sphere_megakernel"))
