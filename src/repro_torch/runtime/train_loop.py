"""Train-step / serve-step factories and the training loop.

Counterpart of ``repro/runtime/train_loop.py``.  ``make_train_step``
builds the step: forward and loss (each trunk block rematerialised under
``remat``), the gradient by ``torch.autograd.grad``, gradient clipping,
optional int8 error-feedback compression (``grad_compression.roundtrip``),
the optimizer update.  Gradient accumulation over microbatches is a Python
loop into accumulators of ``grad_accum_dtype``, where the reference scans
with ``lax.scan``.  ``train_loop`` is the host loop with the reference's
checkpoint, straggler-monitor and preemption hooks.

``make_prefill_step`` / ``make_decode_step`` are the LM serving entry
points: a forward over a whole prompt (where the flash-attention and WKV
kernels run, with ``use_kernel=True``) and one decode step against the
caches, both under ``torch.no_grad()``.

Differences of form from the reference:

  * The train step updates the state it is given **in place** (parameters,
    moments, step, error feedback), as the reference's step does under a
    donating ``jit``, and returns it; a caller who keeps the old state
    clones it first.  Otherwise ``qwen1.5-4b``'s step (47 GB of state in
    bf16 parameters and float32 moments) would not fit one card.
  * The hand-written kernels are forward only, as the reference's Pallas
    kernels are (neither has a derivative rule there), so
    ``TrainStepConfig(use_kernel=True)`` raises ``NotImplementedError``;
    training runs the plain attention and recurrence, as the reference's
    default does.
  * The mesh options (``microbatch_sharding``, ``grad_sharding``,
    ``act_sharding``, ``sp_sharding``) raise ``NotImplementedError`` until
    training on a mesh (ROADMAP A.12c).
  * The metrics stay device tensors; ``train_loop`` reads them on the host
    only at ``log_every``, and its straggler monitor waits on
    ``torch.cuda.synchronize()`` where the reference blocks on the loss.
  * The step is timed in profiles by ``torch.profiler.record_function``
    ranges: ``train_step/forward_backward``, ``train_step/clip``,
    ``train_step/compress`` and ``train_step/update``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as mdl
from repro_torch.optim import grad_compression as gc
from repro_torch.optim import optimizer as opt


class TrainState(NamedTuple):
    """Carried training state: params, optimizer state, error feedback."""
    params: Any
    opt_state: opt.OptState
    err_state: Any            # grad-compression error feedback (or None)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """Configuration of the train step (the reference's fields)."""
    microbatches: int = 1
    clip_norm: float = 1.0
    compress_grads: bool = False
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots | dots_no_batch
    use_kernel: bool = False        # raises: the kernels are forward only
    # the mesh options: each raises until training on a mesh (A.12c)
    microbatch_sharding: Optional[Any] = None
    act_sharding: Optional[Any] = None
    sp_sharding: Optional[Any] = None
    moe_dispatch: str = "dense"     # dense | sparse (gather-based, capacity)
    # type of the gradient accumulator over microbatches
    grad_accum_dtype: Any = torch.float32
    grad_sharding: Optional[Any] = None


def make_train_state(cfg: ArchConfig, optimizer: opt.Optimizer,
                     generator: torch.Generator = None,
                     compress: bool = False, device=None) -> TrainState:
    """Parameters drawn from ``generator`` on ``device`` (default ``cuda``;
    see ``models.init_params``), the optimizer's state and, with
    ``compress``, the zero error feedback."""
    params = mdl.init_params(cfg, generator, device=device)
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        err_state=gc.init_error_state(params) if compress else None)


def make_train_state_abstract(cfg: ArchConfig, optimizer: opt.Optimizer,
                              compress: bool = False) -> TrainState:
    """The ``TrainState`` on the ``meta`` device (shapes and types, no
    storage), for the dry run."""
    return make_train_state(cfg, optimizer, compress=compress,
                            device="meta")


def _check(tcfg: TrainStepConfig) -> None:
    if tcfg.use_kernel:
        raise NotImplementedError(
            "training through the hand-written kernels: they are forward "
            "only, as the reference's Pallas kernels (whose gradient fails "
            "in the Pallas JVP rule); train with use_kernel=False")
    for name in ("microbatch_sharding", "grad_sharding", "act_sharding",
                 "sp_sharding"):
        if getattr(tcfg, name) is not None:
            raise NotImplementedError(f"TrainStepConfig.{name} comes with "
                                      "training on a mesh (ROADMAP A.12c)")


def make_value_and_grad(cfg: ArchConfig,
                        tcfg: TrainStepConfig = TrainStepConfig()
                        ) -> Callable:
    """Returns value_and_grad(params, inputs, labels) -> (loss, grads):
    the train step's loss and gradient, accumulated over
    ``tcfg.microbatches`` in ``grad_accum_dtype`` (the gradient of one
    microbatch keeps the parameters' types)."""
    _check(tcfg)

    def one(params, x, y):
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            loss = mdl.loss_fn(pytree.tree_unflatten(live, spec), cfg, x, y,
                               remat=tcfg.remat,
                               remat_policy=tcfg.remat_policy,
                               moe_dispatch=tcfg.moe_dispatch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), pytree.tree_unflatten(grads, spec)

    def value_and_grad(params, inputs, labels):
        mb = tcfg.microbatches
        if mb == 1:
            return one(params, inputs, labels)
        B = inputs.shape[0]
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} "
                             "microbatches")
        xs = inputs.reshape(mb, B // mb, *inputs.shape[1:])
        ys = labels.reshape(mb, B // mb, *labels.shape[1:])
        acc = pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=tcfg.grad_accum_dtype,
                                  device=p.device), params)
        acc_leaves = pytree.tree_leaves(acc)
        loss = 0.0
        for x, y in zip(xs, ys):
            l, g = one(params, x, y)
            with torch.no_grad():
                torch._foreach_add_(acc_leaves, [
                    gi.to(a.dtype) for a, gi in
                    zip(acc_leaves, pytree.tree_leaves(g))])
            del g
            loss = loss + l
        with torch.no_grad():
            torch._foreach_div_(acc_leaves, mb)
        return loss / mb, acc

    return value_and_grad


def make_train_step(cfg: ArchConfig, optimizer: opt.Optimizer,
                    tcfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    """Returns train_step(state, inputs, labels) -> (state, metrics); the
    state is updated in place (see the module docstring).  ``inputs`` and
    ``labels`` may be numpy arrays (the data stream's batches) or tensors;
    they go to the state's device."""
    value_and_grad = make_value_and_grad(cfg, tcfg)

    def train_step(state: TrainState, inputs, labels):
        device = state.opt_state.step.device
        x = torch.as_tensor(inputs, device=device)
        y = torch.as_tensor(labels, device=device)
        with record_function("train_step/forward_backward"):
            loss, grads = value_and_grad(state.params, x, y)
        with record_function("train_step/clip"):
            grads, gnorm = opt.clip_by_global_norm(grads, tcfg.clip_norm)
        err_state = state.err_state
        if tcfg.compress_grads:
            with record_function("train_step/compress"):
                grads, err_state = gc.roundtrip(grads, err_state)
        with record_function("train_step/update"):
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            del grads
            params = opt.apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": opt_state.step.clone()}
        return TrainState(params, opt_state, err_state), metrics

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ArchConfig, use_kernel: bool = False) -> Callable:
    """prefill_step(params, inputs) -> logits (forward only)."""

    def prefill_step(params, inputs):
        with torch.no_grad():
            logits, _ = mdl.forward(params, cfg, inputs,
                                    use_kernel=use_kernel, remat=False)
        return logits

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """decode_step(params, state, tokens) -> (logits, state)."""

    def step(params, state, tokens):
        with torch.no_grad():
            return mdl.decode_step(params, cfg, state, tokens)

    return step


# ---------------------------------------------------------------------------
# Host-side training loop with fault tolerance hooks
# ---------------------------------------------------------------------------

def _wait(value) -> None:
    """Wait for the device that computes ``value``."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


def train_loop(train_step: Callable, state, data_iter, num_steps: int, *,
               checkpoint_manager=None, checkpoint_every: int = 100,
               monitor=None, preemption_flag=None, log_every: int = 10,
               start_step: int = 0):
    """Run the loop with checkpoint/restart + straggler monitoring hooks.

    ``data_iter`` yields ``(step, (inputs, labels))``.
    ``preemption_flag``: a callable returning True when this host must stop
    (the SIGTERM handler of ``launch/train.py`` sets it); the loop then
    checkpoints and exits cleanly — the restart resumes from the same step
    with identical data.  Returns ``(state, history)``: the metrics of
    every ``log_every``-th step, read on the host as floats.
    """
    history = []
    step = start_step
    for _ in range(num_steps):
        t0 = time.perf_counter()
        data_step, (x, y) = next(data_iter)
        state, metrics = train_step(state, x, y)
        if monitor is not None:
            _wait(metrics["loss"])
            monitor.record(step, time.perf_counter() - t0)
        if step % log_every == 0:
            history.append({k: float(v) for k, v in metrics.items()})
        step += 1
        if checkpoint_manager is not None and step % checkpoint_every == 0:
            checkpoint_manager.save(step, state)
        if preemption_flag is not None and preemption_flag():
            if checkpoint_manager is not None:
                checkpoint_manager.save(step, state, blocking=True)
            break
    if checkpoint_manager is not None:
        checkpoint_manager.wait()
    return state, history
