"""Weights drawn from the seed on the device, in the type they are served
in, in a few large calls.

The tree (names, shapes, types) is the port's parameter layout
(``repro_torch.models.model.init_params_abstract``); the values are the
benchmark's own, so the program and the plain reference are handed the
same tensors.  The configuration file's ``init`` rules give each leaf its
distribution: the first rule whose pattern (``fnmatch``, on the leaf's path
such as ``blocks/3/attn/w_q``) matches decides.  Kinds:

* ``normal``: N(0, 1) · scale + shift;
* ``normal_fan_in``: N(0, 1) · scale / √(shape[-2]) + shift, where
  shape[-2] is a matrix's input width (an expert stack's too);
* ``uniform``: U[0, 1) · scale + shift.

All leaves of one (type, base distribution) share one flat buffer filled
by one ``torch.randn`` / ``torch.rand`` call; each leaf is a view of it,
starting on a 512-byte boundary, scaled in place.
"""
from __future__ import annotations

import fnmatch
import math
from typing import Dict, List, Tuple

import torch

from portbench.harness.seeds import generator

ALIGN_BYTES = 512


def flatten(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """[(path, leaf)] of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        out = []
        for key in tree:
            out += flatten(tree[key], f"{prefix}{key}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += flatten(sub, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def _rebuild(tree, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return leaves[prefix[:-1]]


def rule_for(path: str, rules) -> Tuple[str, float, float]:
    for pattern, kind, scale, shift in rules:
        if fnmatch.fnmatchcase(path, pattern):
            return kind, float(scale), float(shift)
    raise ValueError(f"no init rule matches the leaf {path!r}")


def draw(abstract_tree, rules, seed: int, device) -> dict:
    """Tensors of ``abstract_tree``'s shapes and types (its leaves may be
    on the ``meta`` device) drawn on ``device`` from ``seed`` by ``rules``."""
    leaves = flatten(abstract_tree)
    groups: Dict[Tuple[torch.dtype, str], list] = {}
    for path, leaf in leaves:
        kind, scale, shift = rule_for(path, rules)
        base = "rand" if kind == "uniform" else "randn"
        if kind == "normal_fan_in":
            scale = scale / math.sqrt(leaf.shape[-2])
        groups.setdefault((leaf.dtype, base), []).append(
            (path, tuple(leaf.shape), scale, shift))
    out: Dict[str, torch.Tensor] = {}
    for gi, ((dtype, base), members) in enumerate(sorted(
            groups.items(), key=lambda kv: (str(kv[0][0]), kv[0][1]))):
        align = ALIGN_BYTES // torch.tensor([], dtype=dtype).element_size()
        offsets, total = [], 0
        for _, shape, _, _ in members:
            offsets.append(total)
            total += -(-math.prod(shape) // align) * align
        gen = generator(seed, f"weights/{gi}", device)
        fill = torch.randn if base == "randn" else torch.rand
        flat = fill(total, generator=gen, device=device, dtype=dtype)
        for (path, shape, scale, shift), off in zip(members, offsets):
            t = flat[off:off + math.prod(shape)].view(shape)
            if scale != 1.0:
                t.mul_(scale)
            if shift != 0.0:
                t.add_(shift)
            out[path] = t
    return _rebuild(abstract_tree, out)
