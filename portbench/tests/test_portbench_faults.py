"""A run with the timed path broken underneath comes out not correct: each
fault of ``harness/faults.py`` planted under the program's prefill step,
the rest of the run as it is (the look for a card skipped: the CPU, smoke
sizes).  The limit is set at smoke size as the cells' are: between the
program's reading and the float8 control's."""
import math
import time

import pytest
import torch

from portbench.tests.smoke import CELLS, small_cell
from portbench.harness import cellrun, compare, faults

SEED = 2 ** 36 + 11


def _smoke_limit(cell):
    cfg, params, pool = cellrun.draw_inputs(cell, SEED, "cpu")
    with torch.no_grad():
        out = cellrun.program_step(cfg)(params, pool[0])
    ref = cellrun.reference_logits(cell, params, pool[0])
    ctrl = cellrun.reference_logits(cell, params, pool[0], mm=compare.fp8_mm)
    lo = compare.readings(out, ref)["logit_rel_err"]
    hi = compare.readings(ctrl, ref)["logit_rel_err"]
    assert hi > 3 * lo
    return math.sqrt(lo * hi), cfg


@pytest.mark.parametrize("name", CELLS)
def test_planted_faults_come_out_not_correct(name):
    cell = small_cell(name)
    limit, cfg = _smoke_limit(cell)
    cell.limits = {"logit_rel_err": limit}
    sound = cellrun.run_cell(cell, SEED, 0.3, False, "cpu",
                             time.perf_counter())
    assert sound["correct"], sound["checks"]
    for fault in faults.FAULTS:
        broken = faults.plant(fault, cellrun.program_step(cfg),
                              cfg.vocab_size)
        res = cellrun.run_cell(cell, SEED, 0.3, False, "cpu",
                               time.perf_counter(), step=broken)
        assert res["correct"] is False, (fault, res["checks"])
