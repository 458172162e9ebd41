"""The port's device rule: entry points run on ``cuda`` unless told otherwise.

An entry point that takes host data or makes tensors from nothing
(``SolveService``, ``batched_cg``, ``interop.from_numpy``,
``interop.params_from_numpy``, ``models.init_params``,
``models.init_decode_state``, the serve launcher) takes ``device=``;
``None`` means ``"cuda"``.  On a host without a CUDA device that raises —
the port never falls back to the CPU in silence; callers that want the
CPU (the tests) pass ``device="cpu"``.  Functions that take tensors run where their
tensors live.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device`` (default ``cuda``); raises when a
    CUDA device is asked for and the host has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU unless told otherwise, and this "
            "host has no CUDA device; pass device='cpu' to run on the CPU")
    return dev
