"""The benchmark of csgrenderer_tpu_torch, the PyTorch and CUDA port.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` renders one cell of ``BENCHMARK.json`` on the card and
prints its result line. Cells, configurations, traffic mixes and metrics
are files found by the names in ``BENCHMARK.json`` (see ``harness.py``).
"""
