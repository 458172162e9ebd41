"""The benchmark's operations-and-bytes arithmetic against the bounds that
PERF.md has used since PRs 13 and 22."""
import pytest

from portbench.tests.smoke import CELLS
from portbench.harness import spec
from portbench.harness.peaks import PEAKS

H100 = PEAKS["H100"]
METRICS = spec.BENCH_DIR / "metrics"


def test_flash_attention_bound_at_granites_shape():
    m = spec.load_module(METRICS / "flash_attention_roofline.py", "fa")
    sec, flops, nbytes = m.bound(4, 2048, 24, 8, 64, H100)
    assert flops / 1e9 == pytest.approx(51.6, abs=0.05)
    assert nbytes / 1e6 == pytest.approx(67.1, abs=0.05)
    assert sec * 1e3 == pytest.approx(0.0521, abs=0.0001)


def test_wkv_bound_at_rwkvs_shape():
    m = spec.load_module(METRICS / "rwkv_wkv_roofline.py", "wkv")
    sec, flops, nbytes = m.bound(4, 2048, 40, 64, H100)
    assert flops / 1e9 == pytest.approx(6.71, abs=0.005)
    assert nbytes / 1e6 == pytest.approx(254.3, abs=0.05)
    assert sec * 1e3 == pytest.approx(0.1002, abs=0.0001)


@pytest.mark.parametrize("name,tflop", zip(CELLS, (16.1, 44.8)))
def test_model_flops_of_a_step(name, tflop):
    """granite: 806 M active non-embedding matrix parameters and a 75.5 M
    head a token, plus causal attention; rwkv6: 2.55 B and 168 M, plus the
    WKV recurrence at 5N² a head and step."""
    cell = spec.load_cell(name)
    flops = cell.reference.step_flops(cell.config, 4, 2048)
    assert flops / 1e12 == pytest.approx(tflop, rel=0.01)
