"""The program's spans and counters as the harness sees them.

The port's forward opens ``record_function`` ranges named ``model.*`` and
``kernels.*`` while a profiler records; the profiler reports each range on
the host and, spanning the device work launched inside it, as an
annotation on the device timeline.  The reduction leaves both out of every
number the accepted readers take (a synthetic trace with and without
them).  ``moe.routed_row_pct`` reads the program's counter of expert rows.
"""
import dataclasses
import time

import pytest
import torch

from portbench.tests.smoke import small_cell
from portbench.tests.test_portbench_trace import Ev, _events
from portbench.harness import cellrun, spec, trace
from portbench.harness.peaks import PEAKS

ACCEPTED = ("prefill_mfu", "device.idle_pct", "matmul.ms_per_step",
            "eager.ms_per_step", "flash_attention_roofline",
            "rwkv_wkv_roofline")
GRANITE = "granite-moe-3b-a800m.score-128x2048"
RWKV = "rwkv6-3b.score-128x2048"


def _with_program_ranges(events):
    """``events`` with the ranges of a block: host ranges on the window's
    thread and their device annotations, nested as the forward nests
    them."""
    ranges = [("model.embed", 0.0, 20.0), ("model.attention", 20.0, 450.0),
              ("kernels.flash_attention", 290.0, 410.0),
              ("model.moe", 450.0, 880.0), ("model.moe.router", 450.0, 500.0),
              ("model.head", 880.0, 945.0)]
    out = list(events)
    for name, a, b in ranges:
        out.append(Ev(name, a, b, False))
        ann = Ev(name, a, b, True)
        ann.annotation = True
        out.append(ann)
    return out


def _readings(events, cell):
    s = trace.reduce_events(events, 2, {"flash_attention": {"fa_forward_tc"},
                                        "rwkv_wkv": {"wkv6_forward"}})
    view = cellrun.RunView(trace=s, config=cell.config, traffic=cell.traffic,
                           peaks=PEAKS["H100"], reference=cell.reference)
    applies = [m["name"] for m in cell.per_layer_spec
               if m["name"] in ACCEPTED
               and cell.name in m.get("workloads", [cell.name])]
    return s, {n: cell.per_layer[n].read(view) for n in applies}


@pytest.mark.parametrize("name", [GRANITE, RWKV])
def test_program_ranges_leave_the_accepted_readers_unchanged(name):
    cell = spec.load_cell(name)
    plain, want = _readings(_events(), cell)
    ranged, got = _readings(_with_program_ranges(_events()), cell)
    assert got == want and len(want) == 5
    assert (ranged.kernels, ranged.busy_s, ranged.window_s, ranged.steps) \
        == (plain.kernels, plain.busy_s, plain.window_s, plain.steps)


@pytest.fixture
def registry():
    from repro_torch.observability import metrics
    reg = metrics.reset_global_registry()
    yield reg
    reg.reset()


def _view(cell, busy_s=1.0):
    s = trace.TraceSummary(window_s=1.0, busy_s=busy_s, steps=1, kernels={},
                           gaps={}, port={})
    return cellrun.RunView(trace=s, config=cell.config, traffic=cell.traffic,
                           peaks=PEAKS["H100"], reference=cell.reference)


def _profiled_step(cell):
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(spec.port_config(cell.config), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = cellrun.program_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (cell.traffic["batch"],
                                               cell.traffic["prompt_len"]))
    step(params, tokens)
    with torch.profiler.profile():
        step(params, tokens)


def test_routed_row_share_reads_the_program_counter(registry):
    cell = small_cell(GRANITE)
    reader = cell.per_layer["moe.routed_row_pct"]
    assert reader.read(_view(cell)) is None
    _profiled_step(cell)
    c = cell.config
    assert reader.read(_view(cell)) == pytest.approx(
        100.0 * c["num_experts_per_tok"] / c["num_local_experts"])
    # nothing traced on the device: nothing to read
    assert reader.read(_view(cell, busy_s=0.0)) is None
    full = spec.load_cell(GRANITE).config
    assert 100.0 * full["num_experts_per_tok"] / full[
        "num_local_experts"] == 20.0


def test_routed_row_share_is_absent_without_experts(registry):
    cell = small_cell(RWKV)
    _profiled_step(cell)
    assert cell.per_layer["moe.routed_row_pct"].read(_view(cell)) is None


def test_an_untraced_step_counts_nothing(registry):
    cell = small_cell(GRANITE)
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(spec.port_config(cell.config), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cellrun.program_step(cfg)(params, torch.zeros(2, 8, dtype=torch.long))
    assert cell.per_layer["moe.routed_row_pct"].read(_view(cell)) is None


def test_a_traced_cpu_run_counts_the_window_alone(registry):
    """``run_cell``'s warm-up runs untraced, so the counter holds the
    window's steps only; on the CPU there is no device time, so the
    reader leaves the metric out of the line."""
    cell = small_cell(GRANITE)
    res = cellrun.run_cell(cell, 2 ** 33 + 7, 0.2, True, "cpu",
                           time.perf_counter())
    assert "moe.routed_row_pct" not in res["metrics"]
    values = registry.snapshot()["moe_expert_rows_total"]["values"]
    N = res["attempted"] * cell.traffic["prompt_len"]
    c = cell.config
    assert values['kind="routed"'] == \
        c["num_hidden_layers"] * c["num_experts_per_tok"] * N
    assert values['kind="computed"'] == \
        c["num_hidden_layers"] * c["num_local_experts"] * N
