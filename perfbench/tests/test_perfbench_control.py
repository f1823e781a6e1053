"""The control on the card, at test sizes: the reference in TF32 (the
precision below the configurations' f32 with TF32 off) in the program's
place fails at least one of each cell's limits, while the program passes
them all.  On the CPU there is no TF32, so the test needs a card."""

import pytest
import torch

from perfbench import harness
from perfbench.tests import cells


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(cells.SMALL))
def test_the_control_fails_a_limit(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 exists only on a CUDA card")
    cell = cells.cpu_cell(workload)
    cell.device = torch.device("cuda", 0)
    program, control = cells.readings(cell)
    assert harness.judge(program, cell.limits)[0], program
    assert not harness.judge(control, cell.limits)[0], control
