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
    default does.  A mesh option that is not a ``NamedSharding`` raises
    ``TypeError``.
  * On a mesh the state is DTensors: the parameters placed by
    ``distributed.sharding.params_specs`` (``sharding.distribute``), the
    moments and the error feedback by the same specs, the step a plain
    0-d tensor every rank holds alike (replicated).  ``train_step`` places
    numpy or plain batches by ``batch_spec`` (batch over ``data``, or
    ``("pod", "data")`` on a mesh with a ``pod`` axis) where the
    reference's ``jit`` takes ``in_shardings``; DTensor batches keep
    theirs.  The mesh options are ``distributed.spec.NamedSharding``s:
    ``microbatch_sharding`` places the (mb, b, ...) split,
    ``act_sharding`` / ``sp_sharding`` go to ``forward``, and
    ``grad_sharding`` (a tree of them shaped like the parameters) places
    each microbatch's gradient and the accumulator, so the partial sums
    over the batch land sharded (a reduce-scatter).  Without it each
    gradient takes its parameter's placements, which the optimizer needs
    (it updates each rank's shards: ``optim.optimizer``).  The loss and
    the gradient norm come back as plain tensors, the same on every rank.
  * The metrics stay device tensors; ``train_loop`` reads them on the host
    only at ``log_every``, and its straggler monitor waits on
    ``torch.cuda.synchronize()`` where the reference blocks on the loss.
  * The step is timed in profiles by spans (``observability.spans.span``:
    ``torch.profiler`` ranges while a profiler records, nothing otherwise):
    ``train_step/forward_backward``, ``train_step/clip``,
    ``train_step/compress`` and ``train_step/update``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch._dtensor import constrain, full, is_dtensor, local, whole
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingRules, batch_spec
from repro_torch.distributed.spec import NamedSharding
from repro_torch.models import model as mdl
from repro_torch.observability.spans import span
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
    # NamedSharding of the microbatched (mb, b, ...) inputs
    microbatch_sharding: Optional[Any] = None
    # NamedSharding of the (B, S, d) activations after the embedding
    act_sharding: Optional[Any] = None
    # NamedSharding of the residual between blocks (sequence parallelism)
    sp_sharding: Optional[Any] = None
    moe_dispatch: str = "dense"     # dense | sparse (gather-based, capacity)
    # type of the gradient accumulator over microbatches
    grad_accum_dtype: Any = torch.float32
    # tree of NamedShardings (like the params) for each microbatch's
    # gradient and the accumulator: the partial sums land sharded
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
    for name in ("microbatch_sharding", "act_sharding", "sp_sharding"):
        value = getattr(tcfg, name)
        if value is not None and not isinstance(value, NamedSharding):
            raise TypeError(f"TrainStepConfig.{name} takes a distributed."
                            f"spec.NamedSharding; got {value!r}")
    if tcfg.grad_sharding is not None and not all(
            isinstance(s, NamedSharding)
            for s in _sharding_leaves(tcfg.grad_sharding)):
        raise TypeError("TrainStepConfig.grad_sharding takes a tree of "
                        "distributed.spec.NamedShardings like the "
                        "parameters")


def _placed(grads, params, shardings):
    """Each gradient placed by its ``NamedSharding`` (``shardings``, a tree
    like the parameters) or, without one, as its parameter is; plain
    tensors unchanged."""
    leaves = pytree.tree_leaves(grads)
    if not any(is_dtensor(g) for g in leaves):
        return grads
    if shardings is None:
        out = [g if not is_dtensor(p) or g.placements == p.placements
               else g.redistribute(p.device_mesh, p.placements)
               for g, p in zip(leaves, pytree.tree_leaves(params))]
    else:
        out = [constrain(g, s) for g, s in zip(leaves, _sharding_leaves(
            shardings))]
    return pytree.tree_unflatten(out, pytree.tree_structure(grads))


def _sharding_leaves(shardings):
    return pytree.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))


def batch_sharding(params) -> Optional[NamedSharding]:
    """Where ``train_step`` places a plain batch: by ``batch_spec`` over
    the mesh of the parameters (``("pod", "data")`` when the mesh has a
    ``pod`` axis, else ``data``); None for plain parameters."""
    leaf = pytree.tree_leaves(params)[0]
    if not is_dtensor(leaf):
        return None
    mesh = leaf.device_mesh
    pod = "pod" if "pod" in (mesh.mesh_dim_names or ()) else None
    return NamedSharding(mesh, batch_spec(ShardingRules(pod=pod)))


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
                               act_sharding=tcfg.act_sharding,
                               sp_sharding=tcfg.sp_sharding,
                               moe_dispatch=tcfg.moe_dispatch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        grads = _placed(pytree.tree_unflatten(grads, spec), params,
                        tcfg.grad_sharding)
        return full(loss.detach()), grads

    def value_and_grad(params, inputs, labels):
        mb = tcfg.microbatches
        if mb == 1:
            return one(params, inputs, labels)
        B = inputs.shape[0]
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} "
                             "microbatches")
        # on a mesh the batch is gathered before the split (DTensor cannot
        # unflatten a split batch dim that mb does not divide into);
        # microbatch_sharding then places the (mb, b, ...) split
        xs, ys = (constrain(whole(a, 0).reshape(mb, B // mb, *a.shape[1:]),
                            tcfg.microbatch_sharding)
                  for a in (inputs, labels))
        acc = _placed(pytree.tree_map(
            lambda p: torch.zeros_like(p, dtype=tcfg.grad_accum_dtype),
            params), params, tcfg.grad_sharding)
        acc_leaves = pytree.tree_leaves(acc)
        loss = 0.0
        for i in range(mb):
            l, g = one(params, xs[i], ys[i])
            with torch.no_grad():
                # each rank adds its own shards (gradient and accumulator
                # share placements)
                torch._foreach_add_([local(a) for a in acc_leaves], [
                    local(gi).to(a.dtype) for a, gi in
                    zip(acc_leaves, pytree.tree_leaves(g))])
            del g
            loss = loss + l
        with torch.no_grad():
            torch._foreach_div_([local(a) for a in acc_leaves], mb)
        # the optimizer updates each rank's shards: the parameters' places
        return loss / mb, _placed(acc, params, None)

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
        placed = batch_sharding(state.params)
        x, y = (a if is_dtensor(a) else constrain(
            torch.as_tensor(a, device=device), placed)
            for a in (inputs, labels))
        with span("train_step/forward_backward"):
            loss, grads = value_and_grad(state.params, x, y)
        with span("train_step/clip"):
            grads, gnorm = opt.clip_by_global_norm(grads, tcfg.clip_norm)
        err_state = state.err_state
        if tcfg.compress_grads:
            with span("train_step/compress"):
                grads, err_state = gc.roundtrip(grads, err_state)
        with span("train_step/update"):
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

def make_prefill_step(cfg: ArchConfig, use_kernel: bool = False,
                      act_sharding=None) -> Callable:
    """prefill_step(params, inputs) -> logits (forward only);
    ``act_sharding`` as ``forward``'s."""

    def prefill_step(params, inputs):
        with torch.no_grad():
            logits, _ = mdl.forward(params, cfg, inputs,
                                    use_kernel=use_kernel, remat=False,
                                    act_sharding=act_sharding)
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
