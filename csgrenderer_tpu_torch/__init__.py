"""csgrenderer_tpu_torch — the PyTorch/CUDA port of ``csgrenderer_tpu``.

The JAX package beside this one is the reference: every module here has a
twin there, and the tests hold each against it on the CPU. This package
imports ``torch`` and never ``jax``; it runs on a host without JAX. Its
hot paths are hand-written CUDA kernels for Hopper (``sm_90a``), built
from ``kernels/csrc`` at first use.

Layer map (bottom-up), mirroring ``csgrenderer_tpu``:

- ``math``     vec3 ops over ``[..., 3]`` tensors, quaternions
- ``camera``   the RTIOW thin-lens camera and the reference shader's camera
- ``scene``    the CSG scene graph, its postfix tape compiler and the
               disjoint-cluster decomposition
- ``render``   counter-based RNG, materials, sphere and CSG-leaf
               intersection, interval lists and the tape evaluator, the
               plain torch integrator (the reference path), next-event
               estimation toward lamps (``lights``) and tonemapping
- ``kernels``  the sphere and voxel grid packers with their plain walks,
               the CUDA sphere megakernel (grid and brute modes), the CUDA
               CSG tape kernel (event flip, global and clustered, and the
               interval-list audit), the CUDA triangle-mesh kernel (brute
               and grid), each with an NEE variant, the shard canary, and
               their build
- ``io``       PNG/PPM, OBJ, GIF, progressive-accumulator checkpoints
- ``models``   built-in scenes (two spheres, RTIOW final, the night
               scenes, the CSG configs 3 and 5, many objects, CSG night,
               the mesh scenes)
- ``utils``    ``RenderConfig``, logging, timing and traces
- ``app``      the renderers over the kernels, the App loop with frames in
               flight, frame statistics, the golden configs
- ``parallel`` the ("tile", "sample") rank mesh over ``torch.distributed``
               and the sharded renders: the plain path, the kernels on
               row slab x sample shards, render-to-noise; a launcher for
               local ranks
- ``convert``  numpy state of the JAX package -> this package's containers

Importing the package initialises no CUDA context and imports no
``triton`` and no ``jax``.
"""

__version__ = "0.1.0"
