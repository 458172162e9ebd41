"""Move problem data and state between numpy (and so the JAX package) and
the PyTorch port.

This system has no model weights: its state is the problem data and the
warm-start cache.  :func:`from_numpy` maps a pytree of numpy arrays
(dicts, tuples, lists) to tensors on a device, :func:`to_numpy` maps
tensors back, so that one set of inputs can feed both packages.  The
warm-start cache crosses through its own ``.npz`` format
(``repro_torch.runtime.WarmStartCache.load`` reads what
``repro.runtime.WarmStartCache.save`` wrote).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import _device


def from_numpy(tree, *, device=None, dtype=None):
    """Every array leaf of ``tree`` as a tensor on ``device`` (default
    ``cuda``), cast to ``dtype`` when given; other leaves pass through."""
    dev = _device.resolve(device)

    def leaf(x):
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.as_tensor(np.asarray(x), device=dev, dtype=dtype)
        return x

    return pytree.tree_map(leaf, tree)


def to_numpy(tree):
    """Every tensor leaf of ``tree`` as a host numpy array."""
    return pytree.tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else x, tree)
