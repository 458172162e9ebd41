"""Move problem data, state and model weights between numpy (and so the JAX
package) and the PyTorch port.

:func:`from_numpy` maps a pytree of numpy arrays (dicts, tuples, lists) to
tensors on a device, :func:`to_numpy` maps tensors back, so that one set
of inputs can feed both packages.  The warm-start cache crosses through
its own ``.npz`` format (``repro_torch.runtime.WarmStartCache.load`` reads
what ``repro.runtime.WarmStartCache.save`` wrote).

Model weights cross with :func:`params_from_numpy` and
:func:`params_to_numpy`.  The JAX pytree and the port's parameter dict
have the same names (``embed/tok``, ``blocks/attn/w_q``, …) and the same
``(d_in, d_out)`` weight layout (MoE expert stacks (E, d, f) included);
the only change is that the JAX ``blocks`` subtree stacks the layers on a
leading L axis and the port keeps a list of per-layer dicts.  bfloat16
arrays reach numpy as ``ml_dtypes.bfloat16``, which ``torch`` does not read: they are recognised
by their dtype's name and their bits reinterpreted (``view`` as 16-bit
integers, then as ``torch.bfloat16``), without importing ``ml_dtypes``.

A training state crosses with :func:`train_state_from_numpy` and
:func:`train_state_to_numpy`: the JAX package's ``TrainState`` (its
parameters, its ``OptState``'s step and moments, its error feedback), as
numpy, holds every tree in the parameters' layout, so each crosses as the
parameters do.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import _device
from repro_torch._dtensor import full


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


def _leaf_to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)                       # a writable copy for from_numpy
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
        return torch.from_numpy(a).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


# the subtrees of every model's parameters (the hybrid adds shared_attn)
_SUBTREES = ("embed", "blocks", "final_norm")


def params_from_numpy(tree, cfg, device=None):
    """The JAX package's parameter pytree of ``cfg``, given as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``), as the port's
    parameters on ``device`` (default ``cuda``), every leaf keeping its
    dtype (the float32 router of a bfloat16 MoE model stays float32).
    ``blocks`` is unstacked into per-layer dicts (stacked expert leaves
    (L, E, ...) become (E, ...) a layer); the hybrid family's
    ``shared_attn`` (one weight set, not stacked) crosses as it is."""
    dev = _device.resolve(device)
    want = _SUBTREES + (("shared_attn",) if cfg.family == "hybrid"
                        else ())
    if set(tree) != set(want):
        raise ValueError(f"params_from_numpy: {cfg.name} has the subtrees "
                         f"{sorted(want)}; got {sorted(tree)}")

    def conv(t):
        return pytree.tree_map(lambda a: _leaf_to_tensor(a, dev), t)

    depths = {np.shape(a)[0] for a in pytree.tree_leaves(tree["blocks"])}
    if depths != {cfg.num_layers}:
        raise ValueError(f"params_from_numpy: blocks stacked to depths "
                         f"{sorted(depths)}, {cfg.name} has "
                         f"{cfg.num_layers} layers")
    return {name: [conv(pytree.tree_map(lambda a: a[i], tree[name]))
                   for i in range(cfg.num_layers)] if name == "blocks"
            else conv(tree[name]) for name in want}


def params_to_numpy(params, bfloat16=None):
    """The port's parameters as the JAX package's pytree of numpy arrays
    (``blocks`` stacked on a leading L axis; ``shared_attn``, where the
    model has one, as it is; DTensors gathered whole, a collective every
    rank of their mesh calls).  bfloat16 tensors come back as arrays of the
    numpy dtype ``bfloat16`` when one is given (for example
    ``jax.numpy.bfloat16``: the bits are carried over exactly), else
    widened to float32 (also exact)."""
    def leaf(t):
        t = full(t.detach()).cpu()
        if t.dtype == torch.bfloat16:
            if bfloat16 is not None:
                return t.view(torch.int16).numpy().view(bfloat16)
            t = t.to(torch.float32)
        return t.numpy()

    spec = pytree.tree_flatten(params["blocks"][0])[1]
    layers = zip(*(pytree.tree_flatten(b)[0] for b in params["blocks"]))
    blocks = pytree.tree_unflatten([torch.stack(ls) for ls in layers], spec)
    return {name: pytree.tree_map(leaf, blocks if name == "blocks"
                                  else params[name]) for name in params}


def _tree_from_numpy(tree, cfg, device):
    return None if tree is None else params_from_numpy(tree, cfg, device)


def train_state_from_numpy(state, cfg, device=None):
    """The JAX package's ``TrainState`` of ``cfg`` given as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, state)``) as the port's
    ``TrainState`` on ``device`` (default ``cuda``): the parameters, the
    optimizer's moments (``nu`` may be None) and the error feedback (None
    or a tree like the parameters) cross as ``params_from_numpy`` carries
    parameters; the step becomes a 0-d int32 tensor."""
    from repro_torch.optim.optimizer import OptState
    from repro_torch.runtime.train_loop import TrainState
    dev = _device.resolve(device)
    o = state.opt_state
    return TrainState(
        params=params_from_numpy(state.params, cfg, dev),
        opt_state=OptState(
            step=torch.tensor(np.asarray(o.step), dtype=torch.int32,
                              device=dev),
            mu=_tree_from_numpy(o.mu, cfg, dev),
            nu=_tree_from_numpy(o.nu, cfg, dev)),
        err_state=_tree_from_numpy(state.err_state, cfg, dev))


def train_state_to_numpy(state, bfloat16=None):
    """The port's ``TrainState`` as the JAX package's layout in numpy: a
    ``TrainState`` of the port's class whose trees are those of
    ``params_to_numpy`` (``bfloat16`` as there) and whose step is a 0-d
    int32 array; rebuild the JAX one with
    ``repro.runtime.train_loop.TrainState(params, OptState(*opt_state),
    err_state)``."""
    from repro_torch.optim.optimizer import OptState
    o = state.opt_state

    def conv(tree):
        return None if tree is None else params_to_numpy(tree, bfloat16)

    return type(state)(
        params=conv(state.params),
        opt_state=OptState(step=np.asarray(o.step.detach().cpu().numpy(),
                                           dtype=np.int32),
                           mu=conv(o.mu), nu=conv(o.nu)),
        err_state=conv(state.err_state))
