"""The control: the reference computed in the nearest precision below the
configuration's, put in the program's place, has to come out not correct.

On the CPU at a tiny size for every kind of work (bfloat16 stage images
and templates for enrolment, bfloat16 coordinates and distances for the
matcher); at each cell's own size on the card, in the tests marked
``card`` (``cudabench/README.md`` names the command that runs them
there)."""

import pytest
import torch

from cudabench import calibrate, harness
from cudabench.tests.tiny import tiny_cell

CELLS = ["polyu_hrf_dbii.enrol", "nist_sd4.identify", "polyu_hrf_dbii.all_pairs",
         "nist_sd4.enrol"]
SEED = 2 ** 31 + 101


@pytest.mark.parametrize("name", CELLS[:3])
def test_control_fails_on_the_cpu(name):
    cell = tiny_cell(name)
    cpu = torch.device("cpu")
    prog = calibrate.readings(cell, SEED, 0.2, cpu)
    ctl = calibrate.readings(cell, SEED, 0.2, cpu, calibrate.CONTROLS[cell.traffic["kind"]])
    assert harness.judge(prog["numbers"], cell.limits)[0]
    assert not harness.judge(ctl["numbers"], cell.limits)[0], ctl


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_own_size(name):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's size runs on a CUDA card")
    cell = harness.load_cell(name)
    dev = torch.device("cuda", 0)
    control = calibrate.CONTROLS[cell.traffic["kind"]]
    prog = calibrate.readings(cell, SEED, 2.0, dev)
    ctl = calibrate.readings(cell, SEED, 2.0, dev, control)
    assert harness.judge(prog["numbers"], cell.limits)[0], prog
    assert not harness.judge(ctl["numbers"], cell.limits)[0], ctl
