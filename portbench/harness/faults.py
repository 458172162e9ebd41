"""Faults planted under the timed path, for the tests and the readings
that show the comparison catches them.  Each wraps a prefill step
``step(params, tokens) -> logits (B, S, V)``:

* ``stale``: returns the first call's answers every time (the state the
  step should have replaced, left as it was);
* ``half_mean``: computes the first half of the batch only and answers
  the rest with the mean of that half's answers;
* ``shifted``: the answer for position t produced at position t + 1;
* ``token_altered``: every eighth token of each prompt altered (+1 mod
  the vocabulary) where the step reads it.
"""
from __future__ import annotations

import torch


def stale(step):
    last = []

    def run(params, tokens):
        out = step(params, tokens)
        if not last:
            last.append(out.clone())
        return last[0]
    return run


def half_mean(step):
    def run(params, tokens):
        h = tokens.shape[0] // 2
        out = step(params, tokens[:h])
        rest = out.mean(0, keepdim=True, dtype=torch.float32).to(out.dtype)
        return torch.cat([out, rest.expand(tokens.shape[0] - h,
                                           *out.shape[1:])])
    return run


def shifted(step):
    def run(params, tokens):
        out = step(params, tokens)
        return torch.cat([out[:, :1], out[:, :-1]], dim=1)
    return run


def token_altered(step, vocab_size: int):
    def run(params, tokens):
        t = tokens.clone()
        t[:, ::8] = (t[:, ::8] + 1) % vocab_size
        return step(params, t)
    return run


FAULTS = {"stale": stale, "half_mean": half_mean, "shifted": shifted,
          "token_altered": token_altered}


def plant(name: str, step, vocab_size: int):
    """``step`` with the fault ``name`` planted under it."""
    if name == "token_altered":
        return token_altered(step, vocab_size)
    return FAULTS[name](step)
