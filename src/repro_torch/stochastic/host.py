"""Drive a ``StochasticSolver`` through a host training loop (PyTorch).

Counterpart of ``repro.stochastic.host``.
:func:`repro_torch.stochastic.run_stochastic` is the vmap-safe loop —
the one implicit differentiation wraps.  This module is the *host-side*
alternative for data-scale runs that want a production training loop's
machinery instead (checkpoints, straggler monitoring, preemption).

The adapters are thin by design: :func:`make_stochastic_train_step` turns
``solver.update`` into the ``(state, x, y) -> (state, metrics)`` step
contract of the JAX package's ``train_loop``, and
:func:`stochastic_data_iter` turns the solver's
:class:`~repro_torch.stochastic.sampler.MinibatchSampler` into the
``(step, (x, y))`` iterator such a loop consumes.  Because the sampler
is ``(seed, step)``-keyed, a loop restarted at ``start_step=k`` sees the
identical minibatch sequence the original run would have.

The JAX adapter's ``jit=`` has no counterpart (PyTorch runs eagerly) and
is not taken; the port's ``train_loop`` itself comes with the training
slice (ROADMAP A.12).
"""
from __future__ import annotations

from typing import Callable


def stochastic_data_iter(sampler, start_step: int = 0):
    """Yield ``(step, batch)`` pairs ``train_loop``-style from a sampler.

    ``sampler.data`` must be an ``(inputs, labels)``-like 2-tuple so a
    loop's ``data_step, (x, y) = next(data_iter)`` unpacking holds.
    Restart-safe: pass the checkpointed step as ``start_step``.
    """
    step = start_step
    while True:
        yield step, sampler.batch_at(step)
        step += 1


def make_stochastic_train_step(solver, *theta) -> Callable:
    """Adapt ``solver.update`` to the ``train_loop`` step contract.

    The carried state is ``(params, solver_state)`` — initialize it with
    ``(init_params, solver.init_state(init_params, *theta))``.  Metrics
    report the post-step minibatch loss and the minibatch-gradient norm
    (the cheap proxy; measure ``solver.l2_optimality_error`` full-batch
    outside the loop for the honest residual).
    """
    def step(carry, x, y):
        params, state = carry
        batch = (x, y)
        new_params, new_state = solver.update(params, state, batch, *theta)
        metrics = {"loss": solver.fun(new_params, batch, *theta),
                   "grad_norm": new_state.error,
                   "step": new_state.iter_num}
        return (new_params, new_state), metrics

    return step
