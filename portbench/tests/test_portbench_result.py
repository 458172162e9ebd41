"""A run's result has exactly the contract's keys, and the command refuses
to run without a card."""
import json
import subprocess
import sys
import time

import pytest

from portbench.tests.smoke import CELLS, ROOT, small_cell
from portbench.harness import cellrun

TOP = {"correct", "attempted", "failed", "metrics", "device", "checks"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_result_keys(name, traced):
    cell = small_cell(name)
    res = cellrun.run_cell(cell, 2 ** 35 + 1, 0.3, traced, "cpu",
                           time.perf_counter())
    want = TOP | ({"breakdown"} if traced else set())
    assert set(res) == want
    assert list(res)[-1] == "checks"
    assert set(res["device"]) == DEVICE | (
        {"busy_s", "window_s"} if traced else set())
    # at smoke sizes the full-size limits need not hold: the keys are tested
    assert isinstance(res["correct"], bool) and res["failed"] == 0
    assert res["attempted"] > 0 and res["attempted"] % 4 == 0
    assert set(res["checks"]) == set(cell.limits)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] >= 0
    if traced:
        # no device time on the CPU: the device metrics are left out
        assert res["metrics"] == {}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # peak_mem_gib is the card's allocator: left out on the CPU
        assert set(res["metrics"]) == {"prefill_tok_s", "ttft_p95_ms",
                                       "setup_s"}
        for m in res["metrics"].values():
            assert m["value"] > 0 and set(m) == {"value", "unit"}
    json.dumps(res)


@pytest.mark.parametrize("batch,k", [(4, 4), (128, 4), (12, 3)])
def test_the_kept_requests_cover_every_band_uniformly(batch, k):
    """One kept request from each of ``k`` bands of the rows, each drawn
    uniformly over the window's (batch, row) pairs of its band."""
    import collections
    import torch
    band, steps, runs = batch // k, 5, 1500
    counts = [collections.Counter() for _ in range(k)]
    logits = torch.arange(float(batch)).view(batch, 1, 1)
    for seed in range(runs):
        sampler = cellrun.Sampler(seed, batch, k)
        slots = torch.full((k, 1, 1), -1.0)
        for i in range(steps):
            sampler.offer(i, logits, slots)
        for j, (i, r) in enumerate(sampler.kept):
            assert j * band <= r < (j + 1) * band and 0 <= i < steps
            assert slots[j].item() == r
            counts[j][(i, r)] += 1
    for c in counts:
        # every pair of the band is drawn, none far from the mean
        assert len(c) == steps * band
        mean = runs / (steps * band)
        assert all(abs(n - mean) < 5 * mean ** 0.5 + 1 for n in c.values())


def test_the_same_seed_gives_the_same_inputs():
    cell = small_cell(CELLS[0])
    a = cellrun.draw_inputs(cell, 2 ** 33 + 5, "cpu")
    b = cellrun.draw_inputs(cell, 2 ** 33 + 5, "cpu")
    c = cellrun.draw_inputs(cell, 2 ** 33 + 6, "cpu")
    from portbench.harness.weights import flatten
    for (_, x), (_, y), (_, z) in zip(flatten(a[1]), flatten(b[1]),
                                      flatten(c[1])):
        assert x.equal(y)
        assert not x.equal(z) or x.std() == 0
    assert a[2].equal(b[2]) and not a[2].equal(c[2])


def test_the_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench/run.py"), "--workload",
         CELLS[0], "--seed", str(2 ** 40), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
