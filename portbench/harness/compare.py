"""The comparison that decides ``correct``, and the control that must fail it.

The program's logits of the sampled requests, every position of each
prompt, are read against the plain reference's float32 logits of the same
prompts under the same weights.  A cell's ``limits`` file says which
readings are compared and their limits; the others are printed only.

* ``argmax_gap``: the widest gap, over all positions, by which the
  reference's logit of the token the program ranks first lies below the
  reference's best logit (0 where both rank the same token first).  This
  is the served-token gap of a greedy decode, read at every position a
  prefill answers.
* ``logit_rel_err``: ‖program − reference‖ / ‖reference‖ over all the
  sampled logits (float32 norms): steady from seed to seed, and what a
  stale, shifted or half-computed answer moves.

A non-finite program logit reads infinite on every reading.

The control is the reference put in the program's place with every matrix
product taken in float8 (e4m3, one scale a tensor): the nearest precision
below the configuration's bfloat16.  ``fp8_mm`` is that product.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch

FP8_MAX = 448.0      # the largest finite float8_e4m3fn


@contextlib.contextmanager
def full_float32():
    """Matrix products in true float32 (TF32 off) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), back in float32."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's matrix product: both operands in float8 e4m3,
    accumulated in float32."""
    return torch.matmul(to_fp8(a), to_fp8(b))


def readings(program: torch.Tensor, reference: torch.Tensor
             ) -> Dict[str, float]:
    """The readings of ``program`` (any float type) against ``reference``
    (float32), both (R, S, V), taken a row at a time; with
    ``argmax_flip_share``, the share of positions whose first-ranked token
    differs, for information."""
    gap, diff2, ref2, flips = 0.0, 0.0, 0.0, 0
    for p, r in zip(program, reference):
        p = p.to(torch.float32)
        if not bool(torch.isfinite(p).all()):
            return {k: math.inf for k in READINGS}
        top = p.argmax(-1, keepdim=True)
        picked = torch.gather(r, -1, top)[..., 0]
        gap = max(gap, float((r.amax(-1) - picked).amax()))
        flips += int((top[..., 0] != r.argmax(-1)).sum())
        diff2 += float(((p - r) ** 2).sum(dtype=torch.float64))
        ref2 += float((r ** 2).sum(dtype=torch.float64))
    return {"argmax_gap": gap,
            "logit_rel_err": math.sqrt(diff2 / max(ref2, 1e-300)),
            "argmax_flip_share": flips / (program.numel()
                                          // program.shape[-1])}


READINGS = ("argmax_gap", "logit_rel_err", "argmax_flip_share")


def verdict(read: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every limited reading is at or under its limit (a limit
    with no reading fails)."""
    return all(k in read and read[k] <= v for k, v in limits.items())
