"""Serve-step factories of the port (the serving half of
``repro/runtime/train_loop.py``).

``make_prefill_step`` / ``make_decode_step`` are the LM serving entry
points: a forward over a whole prompt (where the flash-attention and WKV
kernels run, with ``use_kernel=True``) and one decode step against the
caches.  Both run under ``torch.no_grad()``.  ``TrainState``,
``make_train_step`` and ``train_loop`` come with the training slice
(ROADMAP A.12).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as mdl


def make_prefill_step(cfg: ArchConfig, use_kernel: bool = False) -> Callable:
    """prefill_step(params, inputs) -> logits (forward only)."""

    def prefill_step(params, inputs):
        with torch.no_grad():
            logits, _ = mdl.forward(params, cfg, inputs,
                                    use_kernel=use_kernel)
        return logits

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """decode_step(params, state, tokens) -> (logits, state)."""

    def step(params, state, tokens):
        with torch.no_grad():
            return mdl.decode_step(params, cfg, state, tokens)

    return step
