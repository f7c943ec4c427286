"""Kernel rows 6-8, the micro-experiments of ``tools/``, on the CPU.

Each mode's plain torch version (``csgrenderer_tpu_torch/tools/exp_*.py``)
is held against the JAX script's own Pallas kernel, imported from
``tools/`` and run through ``pl.pallas_call(..., interpret=True)`` at
n_iter = 8 (rr_pad = 64 for exp_dot_k), and against the float64 formula.
The sums are taken in different orders, so each pair is held to
|a - b| <= 1e-6 * sum|terms| (sum|terms|: every table entry read, with
multiplicity). The port's inputs are held to the JAX scripts' main()
inputs, byte for byte. The CUDA kernels are held to these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from csgrenderer_tpu_torch.tools import common, exp_dot_k, exp_gather, exp_slab

REPO = pathlib.Path(__file__).resolve().parent.parent
N_ITER = 8
RR_PAD = 64


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {name: _script(name) for name in ("exp_gather", "exp_slab", "exp_dot_k")}


def _interpret(kernel, *arrays):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32), interpret=True,
    )(*(jnp.asarray(a) for a in arrays)))


def _held(got, ref, terms):
    err, ratio = common.agreement(got, ref, terms)
    assert ratio <= 1.0, f"max |err| {err:.3e} is {ratio:.3f} x the bound"


# --- row 8: exp_gather ---------------------------------------------------------


@pytest.mark.parametrize("mode", exp_gather.MODES)
def test_gather_matches_jax_interpret_and_numpy(mode, scripts, monkeypatch):
    js = scripts["exp_gather"]
    monkeypatch.setattr(js, "N_ITER", N_ITER)  # the kernel reads its loop length from here
    tab, idx = exp_gather.make_inputs()
    ref, terms = exp_gather.gather_numpy(tab.numpy(), idx.numpy(), N_ITER)
    got = exp_gather.gather(tab, idx, mode, N_ITER)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    jax_out = _interpret(functools.partial(js.kernel_gather, mode=mode), tab.numpy(), idx.numpy())
    _held(got.numpy(), ref, terms)
    _held(got.numpy(), jax_out, terms)
    _held(jax_out, ref, terms)


# --- row 7: exp_slab -----------------------------------------------------------


@pytest.mark.parametrize("mode", exp_slab.MODES)
def test_slab_matches_jax_interpret_and_numpy(mode, scripts):
    js = scripts["exp_slab"]
    tab_lane, tab_sub, idx = exp_slab.make_inputs()
    tab = tab_lane if mode == "lane" else tab_sub
    ref, terms = exp_slab.slab_numpy(tab.numpy(), idx.numpy(), mode, N_ITER)
    got = exp_slab.slab(tab, idx, mode, N_ITER)
    jax_out = _interpret(functools.partial(js.kernel, mode=mode, n_iter=N_ITER), tab.numpy(),
                         idx.numpy())
    _held(got.numpy(), ref, terms)
    _held(got.numpy(), jax_out, terms)
    _held(jax_out, ref, terms)
    assert np.all(got.numpy() == got.numpy()[0, 0])  # every entry is the one sum


# --- row 6: exp_dot_k ----------------------------------------------------------


def _dot_k_table(rr_pad, seed=6):
    tab = np.random.default_rng(seed).standard_normal((32 * rr_pad, 128))
    return tab.astype(ml_dtypes.bfloat16), np.random.default_rng(seed + 1).integers(
        0, 32, (8, 128)).astype(np.int32)


@pytest.mark.parametrize("mode", exp_dot_k.MODES)
def test_dot_k_matches_jax_interpret_and_numpy(mode, scripts):
    """At rr_pad 64, pw 32, k 8 (the q3 serve shape). "direct" computes
    "base"'s function: it is held to JAX's base variant."""
    js = scripts["exp_dot_k"]
    pw, k = 32, 8
    tab_np, idx_np = _dot_k_table(RR_PAD)
    tab = torch.from_numpy(tab_np.astype(np.float32)).to(torch.bfloat16)
    idx = torch.from_numpy(idx_np)
    ref, terms = exp_dot_k.dot_k_numpy(tab_np.astype(np.float64), idx_np, RR_PAD, pw, k, mode,
                                       N_ITER)
    got = exp_dot_k.dot_k(tab, idx, RR_PAD, pw, k, mode, N_ITER)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    variant = "base" if mode == "direct" else mode
    jax_out = _interpret(functools.partial(js.kernel, rr_pad=RR_PAD, pw=pw, k=k, n_iter=N_ITER,
                                           variant=variant), tab_np, idx_np)
    _held(got.numpy(), ref, terms)
    _held(got.numpy(), jax_out, terms)
    _held(jax_out, ref, terms)


def test_dot_k_vote_term_and_pages():
    """The vote's row 0 as JAX forms it (k row-wise minima of the page
    tile), and the page schedule of the dynamic and static modes."""
    idx = np.array([[5, 3, 3, 9] + [40] * 124] + [[0] * 128] * 7, np.int32)
    extra = exp_dot_k.vote_row0(idx, 2)
    # pass 1 takes the 3s, pass 2 the 5; the 9 and the 40s are never picked
    assert extra[:4].tolist() == [-1.0, -1.0, -1.0, -2.0] and np.all(extra[4:] == -2.0)
    assert exp_dot_k.page_ids("base", 4, 9)[8].tolist() == [0, 1, 2, 3]  # (8*4 + j) mod 32
    assert exp_dot_k.page_ids("static_slab", 4, 3).tolist() == [[0, 1, 2, 3]] * 3


# --- the inputs and the entry points --------------------------------------------


def test_inputs_are_the_jax_scripts(scripts):
    """make_inputs repeats each script's main(): default_rng(0), the same
    draws in the same order, bf16 rounded as ml_dtypes rounds."""
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(115, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (8, 128)).astype(np.int32)
    got = exp_gather.make_inputs()
    assert np.array_equal(got[0].numpy(), tab) and np.array_equal(got[1].numpy(), idx)

    rng = np.random.default_rng(0)
    lane = rng.standard_normal((248, 3584)).astype(np.float32)
    idx = rng.integers(0, 28, (8, 128)).astype(np.int32)
    got = exp_slab.make_inputs()
    assert np.array_equal(got[0].numpy(), lane) and np.array_equal(got[2].numpy(), idx)
    for p in (0, 13, 27):  # page p of both layouts is the same slab
        assert np.array_equal(got[1].numpy()[p * 248:(p + 1) * 248], lane[:, p * 128:(p + 1) * 128])

    rng = np.random.default_rng(0)
    idx = rng.integers(0, 32, (8, 128)).astype(np.int32)
    got_idx, runs = exp_dot_k.make_inputs()
    assert np.array_equal(got_idx.numpy(), idx)
    assert [c for c, _ in runs[:len(exp_dot_k.COMBOS)]] == [
        (248, 64, 4, "base"), (248, 64, 4, "kdots"), (248, 64, 4, "hoist_onehot"),
        (248, 64, 4, "static_slab"), (248, 32, 4, "kdots"), (248, 32, 4, "hoist_onehot"),
        (248, 64, 8, "kdots"), (248, 64, 4, "vote"), (248, 32, 8, "vote"),
        (64, 32, 8, "base"), (64, 32, 8, "vote")]
    for combo, tab in runs[:len(exp_dot_k.COMBOS)]:
        want = rng.standard_normal((32 * combo[0], 128)).astype(ml_dtypes.bfloat16)
        assert np.array_equal(tab.float().numpy(), want.astype(np.float32)), combo
    direct = {c[:3]: t for c, t in runs if c[3] == "direct"}
    assert sorted(direct) == sorted({c[:3] for c in exp_dot_k.COMBOS})
    assert direct[(248, 64, 4)] is runs[0][1]


@pytest.mark.parametrize("tool", [exp_gather, exp_slab, exp_dot_k], ids=lambda m: m.__name__)
def test_main_on_the_cpu_and_refusals(tool, capsys):
    """Each tool's main() runs its modes (the plain versions on the CPU, at
    a tiny loop length) and prints one line per run; --device cuda without
    CUDA exits naming --device cpu; unknown modes raise."""
    rows = tool.main(["--device", "cpu", "--n-iter", "2", "--long", "4", "--reps", "1"])
    out = capsys.readouterr().out
    assert len(rows) == len(out.strip().splitlines()) and "[plain, CPU clock]" in out
    assert all(r["tol_ratio"] <= 1.0 for r in rows)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            tool.main([])
    with pytest.raises(ValueError, match="mode"):
        tool._check_mode("sideways")
    assert tool.LAUNCHES == 0  # CPU tensors never launch
