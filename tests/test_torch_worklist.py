"""The port's grid packer and plain grid walk against the JAX package.

``pack_grid`` must make the JAX packer's choices (grid geometry, globals,
per-cell membership, reorder); ``grid_nearest_hit`` must find what brute
force finds. Both use the same quadratic arithmetic, so hits, t and ids
agree exactly; the bound is t within 1e-5 relative and the same sphere
except on exact ties in t.
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu.kernels import worklist as jwl
from csgrenderer_tpu.models import rtiow_final_scene as j_rtiow
from csgrenderer_tpu.models import two_spheres_scene as j_two
from csgrenderer_tpu_torch.kernels.worklist import BIG_CUT, grid_nearest_hit, pack_grid
from csgrenderer_tpu_torch.models import rtiow_final_scene, two_spheres_scene
from csgrenderer_tpu_torch.render.intersect import spheres_nearest_hit


@pytest.fixture(scope="module")
def packs():
    jp, js = jwl.pack_grid(j_rtiow())
    tp, ts = pack_grid(rtiow_final_scene())
    return jp, js, tp, ts


def test_pack_grid_static_matches_jax(packs):
    jp, _, tp, _ = packs
    for f in ("cx", "cz", "m", "x0", "z0", "cell", "y_lo", "y_hi"):
        assert getattr(tp.static, f) == getattr(jp.static, f), f
    assert (tp.static.cx, tp.static.cz, tp.static.m) == (11, 11, 8)


def test_pack_grid_globals_and_order_match_jax(packs):
    jp, js, tp, ts = packs
    assert tp.n_globals == jp.n_globals == 4
    np.testing.assert_array_equal(tp.order, jp.order)
    assert set(tp.order[: tp.n_globals]) == set(jp.order[: jp.n_globals])
    for f in ("centers", "radii", "mat_kind", "albedo", "mat_param"):
        assert getattr(ts, f).numpy().tobytes() == np.asarray(getattr(js, f)).tobytes(), f


def _jax_cell_members(jp):
    m = jp.static.m
    tab = jp.table
    members = []
    for c in range(jp.static.cx * jp.static.cz):
        live = tab[6 * m : 7 * m, c] != jwl.PAD_R2  # r2_hi of an empty slot
        ids = (tab[8 * m : 9 * m, c] + tab[9 * m : 10 * m, c])[live]
        members.append(sorted(int(i) for i in ids))
    return members


def test_pack_grid_cell_membership_matches_jax(packs):
    jp, _, tp, _ = packs
    ref = _jax_cell_members(jp)
    ids = tp.cell_ids.numpy()
    assert ids.dtype == np.int32 and ids.shape == (len(ref), tp.static.m)
    got = []
    for row in ids:
        live = row[row >= 0]
        assert (row[len(live):] == -1).all()  # packed from slot 0
        got.append(sorted(int(i) for i in live))
    assert got == ref
    assert sum(len(c) for c in got) > 0


def test_pack_grid_declines_small_scenes():
    assert pack_grid(two_spheres_scene()) is None
    assert jwl.pack_grid(j_two()) is None


RAY_FAMILIES = ["aimed", "horizontal-in-slab", "axis", "inside", "steep"]


def _rays(family, cg, n=4096):
    rng = np.random.default_rng(RAY_FAMILIES.index(family) + 11)
    o = np.empty((n, 3), np.float32)
    d = np.empty((n, 3), np.float32)
    if family == "aimed":  # from around the lattice into it
        o[:] = rng.uniform([-14, -0.5, -14], [14, 4, 14], (n, 3))
        d[:] = rng.uniform([-11, 0, -11], [11, 0.4, 11], (n, 3)) - o
    elif family == "horizontal-in-slab":
        o[:, 0], o[:, 2] = rng.uniform(-12, 12, n), rng.uniform(-12, 12, n)
        o[:, 1] = rng.uniform(0.05, 0.35, n)
        d[:] = rng.normal(size=(n, 3))
        d[:, 1] = rng.uniform(-1e-3, 1e-3, n)
    elif family == "axis":
        o[:, 0], o[:, 2] = rng.uniform(-12, 12, n), rng.uniform(-12, 12, n)
        o[:, 1] = rng.uniform(0.0, 0.5, n)
        d[:] = 0.0
        d[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    elif family == "inside":
        o[:] = cg[rng.integers(0, cg.shape[0], n)] + rng.normal(size=(n, 3)) * 0.05
        d[:] = rng.normal(size=(n, 3))
    else:  # steep
        o[:, 0], o[:, 2] = rng.uniform(-12, 12, n), rng.uniform(-12, 12, n)
        o[:, 1] = 5.0
        d[:] = rng.normal(size=(n, 3)) * 0.05
        d[:, 1] = -1.0
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("family", RAY_FAMILIES)
def test_grid_walk_matches_brute_force(packs, family):
    _, _, pack, scene = packs
    o, d = _rays(family, scene.centers[pack.n_globals :].numpy())
    tg, ig, hg = grid_nearest_hit(pack, scene, o, d)
    tb, ib, hb = spheres_nearest_hit(o, d, scene.centers, scene.radii, t_min=1e-3)
    np.testing.assert_array_equal(hg.numpy(), hb.numpy())
    assert hg.any()
    both = hg & hb
    np.testing.assert_allclose(tg[both].numpy(), tb[both].numpy(), rtol=1e-5, atol=0)
    differ = both & (ig != ib)
    # a different sphere only on an exact tie in t
    assert bool((tg[differ] == tb[differ]).all())
    assert bool((tg[~hg] >= BIG_CUT).all())


@pytest.mark.parametrize("family", RAY_FAMILIES)
def test_grid_walk_counts_its_work(packs, family):
    """``counts=`` leaves the hits as they are and adds the walk's work:
    every ray tests the globals, a ray that walks visits at least one cell,
    and a visit tests at most the cell's ``m`` slots."""
    _, _, pack, scene = packs
    o, d = _rays(family, scene.centers[pack.n_globals :].numpy())
    counts = {}
    got = grid_nearest_hit(pack, scene, o, d, counts=counts)
    for a, b in zip(got, grid_nearest_hit(pack, scene, o, d)):
        assert torch.equal(a, b)
    c = {k: int(v) for k, v in counts.items()}
    assert c["global_tests"] == o.shape[0] * pack.n_globals
    assert 0 < c["walks"] <= o.shape[0]
    assert c["walks"] <= c["cell_visits"] <= c["walks"] * pack.static.max_steps
    assert 0 < c["sphere_tests"] <= c["cell_visits"] * pack.static.m
