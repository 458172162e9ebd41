"""The plain references against the port's prefill (plain path, float32)
on the smoke sizes: the same function of the same weights."""
import pytest
import torch

from portbench.tests.smoke import CELLS, small_cell
from portbench.harness import cellrun, compare


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 2 ** 40 + 3])
def test_reference_matches_the_ports_prefill(name, seed):
    cell = small_cell(name, torch_dtype="float32")
    cfg, params, pool = cellrun.draw_inputs(cell, seed, "cpu")
    from repro_torch.runtime.train_loop import make_prefill_step
    with torch.no_grad():
        out = make_prefill_step(cfg, use_kernel=False)(params, pool[0])
    ref = cellrun.reference_logits(cell, params, pool[0])
    read = compare.readings(out, ref)
    assert read["logit_rel_err"] < 1e-5, read
    assert read["argmax_flip_share"] == 0.0, read


@pytest.mark.parametrize("name", CELLS)
def test_reference_sees_every_weight(name):
    """Perturbing any one leaf of the weights moves the reference's logits:
    no part of the model is left out of the check."""
    from portbench.harness.weights import flatten
    cell = small_cell(name, torch_dtype="float32", prompt_len=16)
    _, params, pool = cellrun.draw_inputs(cell, 5, "cpu")
    base = cellrun.reference_logits(cell, params, pool[0])
    for path, leaf in flatten(params):
        saved = leaf.clone()
        leaf.add_(0.5 * torch.randn_like(leaf) + 0.1)
        moved = cellrun.reference_logits(cell, params, pool[0])
        leaf.copy_(saved)
        assert not torch.allclose(moved, base, rtol=0, atol=1e-6), path
