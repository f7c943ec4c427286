"""PCG4D and the samplers of the port against the JAX package.

The counters are emulated uint32 in int64 on the torch side (torch's CPU
uint32 has no + or >>), so the hash must be bit-exact; the samplers go
through sin/cos/sqrt and match to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgrenderer_tpu.kernels.common import pcg4d_planes as jax_pcg4d_planes
from csgrenderer_tpu.render import sampling as jsamp
from csgrenderer_tpu_torch.render import sampling as tsamp


def _counters(n=10_000, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2**32, size=(4, n), dtype=np.uint64).astype(np.uint32)
    c[:, 0] = 0
    c[:, 1] = 2**32 - 1
    c[0, 2], c[1, 2], c[2, 2], c[3, 2] = 0, 2**32 - 1, 0xA5A5A5A5, 1
    return c


def test_pcg4d_bit_exact():
    c = _counters()
    ref = [np.asarray(w) for w in jsamp.pcg4d(*(jnp.asarray(x) for x in c))]
    got = tsamp.pcg4d(*(torch.from_numpy(x.astype(np.int64)) for x in c))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r.astype(np.int64), g.numpy())


def test_uniform4_bit_exact():
    c = _counters(seed=1)
    ref = np.asarray(jsamp.uniform4(*(jnp.asarray(x) for x in c)))
    got = tsamp.uniform4(*(torch.from_numpy(x.astype(np.int64)) for x in c)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(ref, got)
    # the TPU kernel's plane twin draws the same numbers
    planes = jax_pcg4d_planes(*(jnp.asarray(x) for x in c))
    np.testing.assert_array_equal(np.stack([np.asarray(p) for p in planes], -1), got)


@pytest.mark.parametrize("scalar_pos", [1, 2, 3])
def test_uniform4_broadcasts_python_ints(scalar_pos):
    """Counters mix tensors and Python ints, as the integrator calls it."""
    c = _counters(n=512, seed=2)
    args_j = [jnp.asarray(x) for x in c]
    args_t = [torch.from_numpy(x.astype(np.int64)) for x in c]
    args_j[scalar_pos] = jnp.uint32(0xA5A5A5A5)
    args_t[scalar_pos] = 0xA5A5A5A5
    np.testing.assert_array_equal(
        np.asarray(jsamp.uniform4(*args_j)), tsamp.uniform4(*args_t).numpy()
    )


def _uniforms(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    u = rng.random((2, n)).astype(np.float32)
    u[:, 0] = 0.0
    u[:, 1] = np.float32(1.0 - 2**-24)
    return u


def test_sample_unit_vector_matches():
    u1, u2 = _uniforms()
    ref = np.asarray(jsamp.sample_unit_vector(jnp.asarray(u1), jnp.asarray(u2)))
    got = tsamp.sample_unit_vector(torch.from_numpy(u1), torch.from_numpy(u2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_sample_in_unit_disk_matches():
    u1, u2 = _uniforms(seed=4)
    ref = np.asarray(jsamp.sample_in_unit_disk(jnp.asarray(u1), jnp.asarray(u2)))
    got = tsamp.sample_in_unit_disk(torch.from_numpy(u1), torch.from_numpy(u2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (np.linalg.norm(got, axis=-1) <= 1.0 + 1e-6).all()
