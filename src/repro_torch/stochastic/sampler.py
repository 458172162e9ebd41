"""Deterministic ``(seed, step)``-keyed minibatch sampling (PyTorch).

Counterpart of ``repro.stochastic.sampler``.  Everything downstream of a
stochastic solver (restart safety, bit-identical replays, the sampled
backward operator) hinges on minibatch selection being a pure function of
``(seed, step)``.  :class:`MinibatchSampler` computes the indices on the
host with NumPy, with the reference's exact streams, so that one seed
draws the same minibatches, index for index, in both packages:

* the *forward* stream ``(seed, 0, step)`` drives the training
  minibatches consumed by :func:`repro_torch.stochastic.run_stochastic`;
* the *backward* stream ``(seed, 1, j)`` draws the ``k`` resampled
  minibatches that :class:`repro_torch.core.SampledJacobianOperator`
  averages Hessian-vector products over.

Rows are gathered with ``index_select`` on the data's device.  ``data``
is a pytree of tensors; NumPy leaves are copied to ``device`` (``None``
means ``cuda``, see ``repro_torch._device``) once, when the sampler is
made.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core._tree import tree_leaves, tree_map


def _leading_dim(data: Any) -> int:
    """The (common) leading-axis length of every leaf in ``data``."""
    leaves = tree_leaves(data)
    if not leaves:
        raise ValueError("MinibatchSampler needs a non-empty data pytree.")
    sizes = {int(np.shape(leaf)[0]) for leaf in leaves}
    if len(sizes) != 1:
        raise ValueError(
            f"data leaves disagree on leading axis length: {sorted(sizes)}")
    return sizes.pop()


def _concat(*leaves):
    """Concatenate stream batches along the example axis."""
    if isinstance(leaves[0], torch.Tensor):
        return torch.cat(leaves, dim=0)
    return np.concatenate([np.asarray(leaf) for leaf in leaves], axis=0)


@dataclasses.dataclass(frozen=True)
class MinibatchSampler:
    """Deterministic, restart-safe minibatch sampler over an in-memory pytree.

    ``data`` is any pytree whose leaves share a leading example axis of
    length ``n``; a minibatch is the same pytree with the leading axis
    gathered down to ``batch_size``.  Sampling is *without replacement
    within a batch* and keyed purely by ``(seed, step)``: the same seed
    replays the identical index trajectory, and a run restarted at step
    ``k`` continues exactly where the original left off.  ``device``
    places NumPy leaves (``None``: ``cuda``); tensor leaves stay where
    they are.
    """

    data: Any
    batch_size: int
    seed: int = 0
    device: Any = None

    def __post_init__(self):
        """Move NumPy leaves to the device; validate the batch size."""
        if any(not isinstance(leaf, torch.Tensor)
               for leaf in tree_leaves(self.data)):
            dev = _device.resolve(self.device)
            object.__setattr__(self, "data", tree_map(
                lambda leaf: leaf if isinstance(leaf, torch.Tensor)
                else torch.as_tensor(np.asarray(leaf), device=dev),
                self.data))
        n = self.num_examples
        if not 0 < self.batch_size <= n:
            raise ValueError(
                f"batch_size={self.batch_size} must be in [1, n={n}]")

    @property
    def num_examples(self) -> int:
        """Dataset length ``n`` (leading-axis length of every leaf)."""
        return _leading_dim(self.data)

    @property
    def num_batches(self) -> int:
        """Minibatches per epoch, ``n // batch_size``."""
        return self.num_examples // self.batch_size

    def _rng(self, *key: int) -> np.random.Generator:
        """A NumPy generator keyed by ``(seed, *key)`` (pure, host-side)."""
        return np.random.default_rng(
            np.random.SeedSequence((self.seed,) + key))

    def indices(self, step: int) -> np.ndarray:
        """Forward-stream indices for ``step``: shape ``(batch_size,)``."""
        return self._rng(0, int(step)).choice(
            self.num_examples, size=self.batch_size, replace=False)

    def batch_indices(self, start_step: int, num_steps: int) -> np.ndarray:
        """Stacked forward indices for steps ``[start, start + num)``.

        Shape ``(num_steps, batch_size)``: the whole index plan of a
        ``run_stochastic`` loop, computed on the host before it starts.
        """
        return np.stack(
            [self.indices(s) for s in range(start_step,
                                            start_step + num_steps)])

    def gather(self, idx) -> Any:
        """Rows ``idx`` (any shape) of every data leaf, on its device:
        leaves of shape ``idx.shape + leaf.shape[1:]``."""
        def take(leaf):
            i = torch.as_tensor(idx, dtype=torch.int64, device=leaf.device)
            rows = leaf.index_select(0, i.reshape(-1))
            return rows.reshape(tuple(i.shape) + tuple(leaf.shape[1:]))

        return tree_map(take, self.data)

    def batch_at(self, step: int) -> Any:
        """The minibatch for ``step`` — pure in ``(seed, step)``."""
        return self.gather(self.indices(step))

    def backward_batches(self, k: int) -> Any:
        """``k`` resampled minibatches stacked on a new leading axis.

        Drawn from the backward stream ``(seed, 1, j)`` so they are
        decorrelated from the forward trajectory; feed the result to
        :class:`repro_torch.core.SampledJacobianOperator`, whose matvec
        averages Hessian-vector products over this axis.
        """
        idx = np.stack([self._rng(1, j).choice(
            self.num_examples, size=self.batch_size, replace=False)
            for j in range(k)])
        return self.gather(idx)

    @classmethod
    def from_stream(cls, stream, num_steps: int, *,
                    batch_size: Optional[int] = None,
                    seed: Optional[int] = None,
                    start_step: int = 0, device=None) -> "MinibatchSampler":
        """Materialize a sampler from a ``batch_at(step)`` data stream.

        Concatenates ``num_steps`` consecutive ``stream.batch_at`` batches
        along the example axis into one in-memory dataset of ``num_steps
        * stream_batch`` examples.  ``batch_size`` defaults to the
        stream's own batch size and ``seed`` to ``stream.cfg.seed`` (or
        ``stream.stream.cfg.seed``, a prefetching wrapper's) when there is
        one, else 0.  Nothing else of the stream is used.
        """
        batches = [stream.batch_at(start_step + s) for s in range(num_steps)]
        data = tree_map(_concat, *batches)
        if batch_size is None:
            batch_size = _leading_dim(batches[0])
        if seed is None:
            cfg = getattr(stream, "cfg", None) or getattr(
                getattr(stream, "stream", None), "cfg", None)
            seed = int(getattr(cfg, "seed", 0))
        return cls(data=data, batch_size=batch_size, seed=seed,
                   device=device)
