"""Error-feedback int8 gradient compression.

Counterpart of ``repro/optim/grad_compression.py``: uniform int8
quantisation in chunks of ``CHUNK`` values with a float32 scale each, and
**error feedback** (the residual is carried to the next step), which keeps
convergence (Karimireddy et al., 2019) while cutting the data-parallel
reduction's bytes 4x against float32.  Rounding is half to even, as
``jnp.round``.

``roundtrip`` is the train step's transform (quantise, then dequantise,
around the gradient mean).  As the rest of the port's train state, the
error state is updated in place: ``compress_tree`` and ``roundtrip`` write
the new residual into the error tensors they are given, and ``roundtrip``
writes the dequantised gradients into the gradient tensors.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree


class Compressed(NamedTuple):
    q: torch.Tensor        # int8 payload (chunks, CHUNK)
    scale: torch.Tensor    # per-chunk scale (chunks, 1), float32


CHUNK = 2048


def _quantize(x: torch.Tensor, chunk: int = CHUNK) -> Compressed:
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % chunk
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, chunk)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return Compressed(q=q, scale=scale)


def _dequantize(c: Compressed, shape, dtype) -> torch.Tensor:
    flat = (c.q.to(torch.float32) * c.scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def init_error_state(grads: Any) -> Any:
    return pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads)


def _one(g: torch.Tensor, e: torch.Tensor):
    """(compressed, reconstruction) of g + e; the residual into ``e``."""
    target = g.to(torch.float32) + e
    c = _quantize(target)
    recon = _dequantize(c, g.shape, torch.float32)
    e.copy_(target - recon)
    return c, recon


@torch.no_grad()
def compress_tree(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Quantise grads + error; returns (compressed tree, error state), the
    new residual written into ``err``."""
    spec = pytree.tree_structure(grads)
    comp = [_one(g, e)[0] for g, e in zip(pytree.tree_leaves(grads),
                                          pytree.tree_leaves(err))]
    return pytree.tree_unflatten(comp, spec), err


def decompress_tree(comp: Any, like: Any) -> Any:
    spec = pytree.tree_structure(like)
    comp_leaves = pytree.tree_leaves(
        comp, is_leaf=lambda x: isinstance(x, Compressed))
    return pytree.tree_unflatten(
        [_dequantize(c, g.shape, g.dtype)
         for c, g in zip(comp_leaves, pytree.tree_leaves(like))], spec)


@torch.no_grad()
def roundtrip(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Quantise, then dequantise, with error feedback: the reconstruction
    is written into ``grads`` (in their type) and the residual into
    ``err``; returns ``(grads, err)``."""
    for g, e in zip(pytree.tree_leaves(grads), pytree.tree_leaves(err)):
        g.copy_(_one(g, e)[1])
    return grads, err
