"""The benchmark's night488_nee deployment through the port's normal path,
on the CPU: ``PathTraceRenderer``'s progressive ``draw_frame`` with
``RenderConfig(nee=True)`` on ``night_scene(grid=11)`` (488 spheres, the
grid-NEE mode), held to the benchmark's plain NEE reference
(``benchmark/reference/nee.py``, which imports nothing of the port), and
planted faults of the estimator that the comparison finds.

On CPU tensors the renderer runs the sphere kernel's plain version, which
the kernel repeats operation for operation (``tests/test_torch_cuda.py``
holds the two together on the card). The reference keeps the same float
grouping, so on the CPU the two take every decision alike:

- each frame's radiance (the accumulator's difference over spp) is held
  to the cell's ``divergent_share`` limit
  (``benchmark/workloads/night-nee-540p64.json``): at most that share of
  (pixel, frame) pairs off by more than ``compare.DIVERGENT`` in a
  channel, the bound the benchmark holds the card's frames to;
- each frame's segments and shadow rays are equal: a count that differs
  is a decision taken otherwise, which no rounding excuses here.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import compare  # noqa: E402
from benchmark.harness import camera, load_module  # noqa: E402
from benchmark.reference import core, nee  # noqa: E402
from csgrenderer_tpu_torch.app import PathTraceRenderer  # noqa: E402
from csgrenderer_tpu_torch.camera import Camera  # noqa: E402
from csgrenderer_tpu_torch.render import lights  # noqa: E402
from csgrenderer_tpu_torch.utils.config import RenderConfig  # noqa: E402

CONFIG = json.loads((REPO / "benchmark" / "configs" / "night488_nee.json").read_text())
SCENES = load_module(REPO / "benchmark" / "configs" / "night488_nee.py", "night488_nee_config")
LIMITS = json.loads((REPO / "benchmark" / "workloads" / "night-nee-540p64.json").read_text())[
    "limits"]
WIDTH, HEIGHT, SPP = 64, 32, 2  # tests/test_kernels.py's frame; the configuration's 6 bounces
FRAMES = 2
SEEDS = (3, 2**31 + 977)


def port_frames(seed: int) -> list:
    """(radiance, segments, shadow rays) of each progressive frame."""
    scene, _ = SCENES.program_scene(CONFIG, "cpu", False, 0.0)
    cam = Camera.look_at(aspect_ratio=WIDTH / HEIGHT, **camera(CONFIG, {}))
    rc = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=CONFIG["bounces"],
                      seed=seed, sky=CONFIG["sky"], gamma=CONFIG["gamma"], nee=CONFIG["nee"])
    r = PathTraceRenderer(scene, cam, rc, progressive=True, device="cpu")
    out, prev = [], r.accumulator
    for _ in range(FRAMES):
        r.draw_frame(0.0)
        acc = r.accumulator
        out.append(((acc.radiance_sum - prev.radiance_sum) / SPP, r.last_frame_rays,
                    r.last_frame_shadow_rays))
        prev = acc
    return out


def reference_frames(seed: int) -> list:
    soup = SCENES.reference_scene(CONFIG, "cpu", torch.float32, 0.0)
    cam = core.Camera.look_at(aspect_ratio=WIDTH / HEIGHT, **camera(CONFIG, {}))
    out = []
    for k in range(FRAMES):
        img, rays, shadow = nee.render_rows(soup, cam, WIDTH, HEIGHT, list(range(HEIGHT)), SPP,
                                            CONFIG["bounces"], seed, CONFIG["sky"], False,
                                            sample_offset=k * SPP, sample_batch=SPP)
        out.append((img, int(rays), int(shadow)))
    return out


def numbers(seed: int) -> dict:
    got, ref = port_frames(seed), reference_frames(seed)
    return {"divergent_share": compare.share(compare.divergent(g[0], r[0])
                                             for g, r in zip(got, ref)),
            "rays": [(g[1], r[1]) for g, r in zip(got, ref)],
            "shadow_rays": [(g[2], r[2]) for g, r in zip(got, ref)]}


def failed(n: dict) -> list:
    """The numbers of ``numbers`` that miss their bound."""
    out = ["divergent_share"] if n["divergent_share"] > LIMITS["divergent_share"] else []
    return out + [k for k in ("rays", "shadow_rays") if any(a != b for a, b in n[k])]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_renders_the_deployment_as_the_reference_does(seed):
    n = numbers(seed)
    assert failed(n) == [], n
    assert all(a > 0 for a, _ in n["shadow_rays"])  # the grid-NEE path ran


def mis_weight_dropped(mp):
    """Lamp emission reached by a pairable scatter counted in full."""
    mp.setattr(lights, "bsdf_mis_scale_any", lambda lamps, o, p, pdf: torch.ones_like(pdf))


def shadow_test_skipped(mp):
    """Every lamp sample taken as unoccluded."""
    orig = lights.nee_contribution

    def unshadowed(hit_fn, *args, **kw):
        def never(p, d):
            h = hit_fn(p, d)
            return h._replace(hit=torch.zeros_like(h.hit))
        return orig(never, *args, **kw)

    mp.setattr(lights, "nee_contribution", unshadowed)


def lamp_pdf_halved(mp):
    """The cone's pdf taken at half its value (its inverse doubled)."""
    orig = lights.sample_sphere_cone

    def halved(*args, **kw):
        d, inv_pdf = orig(*args, **kw)
        return d, 2.0 * inv_pdf

    mp.setattr(lights, "sample_sphere_cone", halved)


FAULTS = (mis_weight_dropped, shadow_test_skipped, lamp_pdf_halved)


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_planted_fault_fails_a_number(monkeypatch, fault):
    fault(monkeypatch)
    n = numbers(SEEDS[0])
    assert failed(n), n
