"""csgrenderer_tpu_torch — the PyTorch/CUDA port of ``csgrenderer_tpu``.

The JAX package beside this one is the reference: every module here has a
twin there, and the tests hold each against it on the CPU. This package
imports ``torch`` and never ``jax``; it runs on a host without JAX. Its
hot path is a hand-written CUDA kernel for Hopper (``sm_90a``), built from
``kernels/csrc`` at first use.

Layer map (bottom-up), mirroring ``csgrenderer_tpu``:

- ``math``     vec3 ops over ``[..., 3]`` tensors
- ``camera``   the RTIOW thin-lens camera
- ``render``   counter-based RNG, materials, sphere intersection, the plain
               torch integrator (the reference path) and tonemapping
- ``kernels``  the grid packer with its plain DDA, the CUDA sphere
               megakernel (grid and brute modes) and its build
- ``io``       PNG/PPM
- ``models``   built-in sphere scenes (two spheres, RTIOW final)
- ``convert``  numpy state of the JAX package -> this package's containers

Importing the package initialises no CUDA context and imports no
``triton`` and no ``jax``.
"""

__version__ = "0.1.0"
