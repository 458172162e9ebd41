"""Pipeline parallelism over a ``stage`` mesh axis (GPipe schedule).

Counterpart of ``repro.distributed.pipeline``: the layer stack is split
into S stages (stage s holds layers [s·L/S, (s+1)·L/S)); microbatches
stream through, activations moving stage → stage.  The loop runs
M + S − 1 ticks, the classic pipelined schedule with bubble fraction
(S−1)/(M+S−1).  Where the JAX package's ``shard_map`` body rotates the
activations with ``lax.ppermute`` and ends with a ``psum`` of the last
stage's outputs, each rank here runs its own stage: the ring is one
``torch.distributed.batch_isend_irecv`` a tick, and at the end the last
stage broadcasts the outputs to the others.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.core._tree import tree_leaves, tree_map
from repro_torch.distributed.sharded_operators import _to_local
from repro_torch.distributed.spec import P, axis_size, dim_index


def pipeline_forward(block_fn: Callable, params_stacked: Any,
                     x_microbatches: torch.Tensor, mesh,
                     stage_axis: str = "stage") -> torch.Tensor:
    """Run ``block_fn(params_layer, x) -> x`` over a stage-sharded stack.

    params_stacked: tree with leading layer axis L (L % S == 0) — plain
      tensors every rank holds alike (each rank takes its stage's L/S
      layers) or DTensors split along L over ``stage_axis``.
    x_microbatches: (M, mb, ...) microbatched input, replicated across
      stages (stage 0 consumes; results exit from the last stage).
    Returns the (M, mb, ...) outputs on every rank (a replicated DTensor
    when ``x_microbatches`` is a DTensor).
    """
    S = axis_size(mesh, stage_axis)
    k = dim_index(mesh, stage_axis)
    stage_id = mesh.get_coordinate()[k]
    params_local = tree_map(
        lambda leaf: _to_local(mesh, leaf,
                               P(stage_axis, *([None] * (leaf.ndim - 1)))),
        params_stacked)
    as_dtensor = isinstance(x_microbatches, DTensor)
    xs = x_microbatches.full_tensor() if as_dtensor else x_microbatches
    M = xs.shape[0]
    n_layers = int(tree_leaves(params_local)[0].shape[0])

    def run_stage(h):
        for i in range(n_layers):
            h = block_fn(tree_map(lambda leaf: leaf[i], params_local), h)
        return h

    group = mesh.get_group(k)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(stage_id + 1) % S], ranks[(stage_id - 1) % S]
    state = torch.zeros_like(xs[0])
    outputs = torch.zeros_like(xs)
    for t in range(M + S - 1):
        mb_idx = t - stage_id
        active = 0 <= mb_idx < M
        # stage 0 ingests a fresh microbatch at ticks [0, M)
        inp = xs[min(max(t, 0), M - 1)] if stage_id == 0 else state
        out = run_stage(inp) if active else state
        if stage_id == S - 1 and active:
            outputs[mb_idx] = out       # the last stage commits its output
        if S == 1:
            state = out
            continue
        # rotate activations to the next stage
        recv = torch.empty_like(out)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)])
        for req in reqs:
            req.wait()
        state = recv
    if S > 1:
        # only the last stage holds real outputs; broadcast them
        dist.broadcast(outputs, src=ranks[S - 1], group=group)
    if as_dtensor:
        return DTensor.from_local(outputs, mesh,
                                  [Replicate()] * mesh.ndim, run_check=False)
    return outputs
