"""Demos of the port, each run with ``python -m
csgrenderer_tpu_torch.demos.<name>`` (twins of the JAX package's
``demos/``)."""
