"""Shared helpers of the benchmark's tests: the real cells at the port's
smoke sizes, on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.harness import spec  # noqa: E402

CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])


def small_cell(name: str, batch: int = 4, prompt_len: int = 64,
               **config) -> spec.Cell:
    """The cell ``name`` as ``BENCHMARK.json`` resolves it, at the sizes of
    its configuration file's ``smoke`` block (widths cut too: these run on
    the CPU in the tests, never as a cell), ``batch`` prompts a step."""
    cell = spec.load_cell(name)
    cell.config = {**cell.config, **cell.config["smoke"], **config}
    cell.traffic = {**cell.traffic, "batch": batch,
                    "prompt_len": prompt_len, "pool_batches": 4}
    return cell


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with `pytest -m cuda "
                    "portbench/tests` on the card)")
    return torch.device("cuda")
