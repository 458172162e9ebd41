"""Stochastic inner solvers: minibatch bilevel optimization at data scale.

Counterpart of ``repro.stochastic``: implicit differentiation riding on
*stochastic* inner solvers (the paper only needs an approximate root of
the optimality mapping — Blondel et al. 2022, §3.3):

  * :class:`MinibatchSampler` — deterministic ``(seed, step)``-keyed
    sampling: indices on the host with the JAX package's NumPy streams,
    gathers on the data's device; restart-safe and vmap-safe.
  * :class:`StochasticSolver` — the protocol on the ``IterativeSolver``
    seam, optimality declared in expectation; :class:`SGD`,
    :class:`MomentumSGD`, :class:`Adam` instances; :func:`run_stochastic`
    the shared loop with Polyak/EMA averaging and a full-batch residual
    diagnostic.
  * implicit diff at the averaged iterate through a sampled Jacobian
    operator (``repro_torch.core.SampledJacobianOperator``) and the
    approximate backward modes.
  * :func:`make_stochastic_train_step` / :func:`stochastic_data_iter` —
    host-side adapters onto a training loop's step contract.
"""
from repro_torch.stochastic.sampler import MinibatchSampler
from repro_torch.stochastic.solvers import (AVERAGING_MODES,
                                            BACKWARD_DATA_MODES, Adam,
                                            MomentumSGD, SGD,
                                            StochasticSolver, run_stochastic)
from repro_torch.stochastic.host import (make_stochastic_train_step,
                                         stochastic_data_iter)

__all__ = [
    "MinibatchSampler",
    "StochasticSolver", "SGD", "MomentumSGD", "Adam", "run_stochastic",
    "AVERAGING_MODES", "BACKWARD_DATA_MODES",
    "make_stochastic_train_step", "stochastic_data_iter",
]
