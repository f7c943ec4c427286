"""The control of each cell's check: the plain reference computed in
bfloat16, the precision below the configuration's float32, put in the
program's place, fails one of the cell's limits; the program passes all."""

import benchmark_cpu
import pytest
import torch


@pytest.mark.parametrize("cell", sorted(benchmark_cpu.TINY))
def test_the_lower_precision_control_fails_a_limit_and_the_program_none(cell):
    run = benchmark_cpu.tiny_run(cell)
    limits = run.cell["limits"]
    assert all(c.ok for c in run.checks), run.checks
    control = run.driver.control(run, torch.bfloat16)
    assert set(control) == set(limits)
    assert any(control[k] > limits[k] for k in limits), control
