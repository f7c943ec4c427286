"""Tools: the converged-image protocol on the card and three micro-experiments.

Twins of the JAX package's ``tools/``, each run with ``python -m``:

- ``validate_gpu``: ``tools/validate_tpu.py``'s protocol (a two-seed noise
  certificate, then the same-seed RMSE of the CUDA kernels against the
  plain torch path) on the configs of BASELINE.json and beyond;
- ``exp_gather``, ``exp_slab``, ``exp_dot_k``: ``tools/exp_gather.py``,
  ``exp_slab.py`` and ``exp_dot_k.py``, each a hand-written CUDA kernel
  (``kernels/csrc/exp_*.cu``) beside its plain torch version, timed by
  slope over ``n_iter`` with CUDA events.

``common`` holds what the experiments share: slope timing, the tolerance
their sums are held to and the check against it. ``shadow_walk_probe``
reproduces an open fault of the mesh kernel (its grid-NEE shadow walk
inlined) on the card.
"""
