"""The one generator of traffic: it reads a mix's parameters from
``portbench/traffic/<name>.json`` and draws the prompts from the seed.

Kinds of loop it knows:

* ``closed``: ``clients`` = 1 client submits ``batch`` prompts of
  ``prompt_len`` tokens at once and waits for their answers before it
  submits the next batch.  A pool of ``pool_batches`` batches is drawn on
  the device before the window (token ids uniform over the vocabulary);
  batch i of the window is pool batch i mod ``pool_batches``.
"""
from __future__ import annotations

import torch

from portbench.harness.seeds import generator

LOOPS = ("closed",)


def check(traffic: dict) -> None:
    if traffic.get("loop") not in LOOPS:
        raise ValueError(f"traffic loop {traffic.get('loop')!r}: the "
                         f"generator knows {LOOPS}")
    if traffic.get("clients", 1) != 1:
        raise ValueError("a closed loop here has one client")


def prompt_pool(traffic: dict, vocab_size: int, seed: int,
                device) -> torch.Tensor:
    """(pool_batches, batch, prompt_len) int64 token ids."""
    check(traffic)
    shape = (int(traffic["pool_batches"]), int(traffic["batch"]),
             int(traffic["prompt_len"]))
    return torch.randint(0, vocab_size, shape, device=device,
                         dtype=torch.int64,
                         generator=generator(seed, "prompts", device))
