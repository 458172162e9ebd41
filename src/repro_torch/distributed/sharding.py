"""Sharding rules: map every param/activation/cache leaf to a PartitionSpec.

Counterpart of ``repro.distributed.sharding``, rule for rule, on the
port's ``PartitionSpec`` (``repro_torch.distributed.spec``).  Strategy —
a 2-D "FSDP × TP" layout:

  * Each weight matrix shards its LARGEST dim over ``model`` (tensor
    parallelism) and its second-largest over ``data`` (ZeRO-3/FSDP),
    subject to divisibility; non-divisible dims fall back to replication
    on that axis.
  * Vectors (norm scales, biases) replicate.
  * Embedding / unembedding shard vocab over ``model``, d_model
    replicated.
  * MoE expert tensors (E, d, f): experts over ``model`` when divisible,
    else the f/d dims take the 2-D layout.
  * The ``pod`` axis is pure data parallelism: batch shards over
    ("pod", "data"); params never shard over ``pod``.
  * Activations: batch over ("pod", "data") [or ``data`` single-pod];
    for long-context decode with batch=1, the KV cache / recurrent state
    shards sequence/heads instead (see ``kv_cache_spec``).

The port's parameter dict has the JAX package's names, but ``blocks`` is
a list of per-layer dicts where the JAX tree stacks the layers on a
leading L axis: a layer's leaf gets the spec the JAX leaf gets without
its leading ``None``.  ``named(mesh, spec_tree)`` binds specs to a mesh
as DTensor placements; ``distribute(tree, mesh, spec_tree)`` places a
tree of tensors that every rank holds alike (a model's parameters drawn
from one seed, a restored state) as DTensors, each rank keeping its own
slice — the port's ``jax.device_put(tree, named(mesh, specs))``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.spec import (AbstractMesh, P, PartitionSpec,
                                          axis_size, placements)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Axis names on the mesh."""
    data: str = "data"
    model: str = "model"
    pod: Optional[str] = None        # present on multi-pod meshes

    @property
    def batch_axes(self):
        return (self.pod, self.data) if self.pod else self.data


def abstract_mesh(axis_sizes: Tuple[int, ...], axis_names: Tuple[str, ...]):
    """A shape-only mesh (no ranks, no process group), so spec
    construction works on any host."""
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def mesh_axis_size(mesh, name) -> int:
    """Extent of a mesh axis, of a tuple of axes (their product), or 1
    for ``None``."""
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= mesh_axis_size(mesh, n)
        return out
    return axis_size(mesh, name)


def _divisible(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               rules: ShardingRules, mesh,
               fsdp: bool = True, attn_tp: bool = True) -> P:
    """2-D FSDP×TP spec for one parameter leaf.

    ``path`` is the dict path (used for embedding special-casing);
    ``shape`` EXCLUDES any stacked layer axis.
    """
    n_model = mesh_axis_size(mesh, rules.model)
    n_data = mesh_axis_size(mesh, rules.data)
    name = "/".join(str(p) for p in path)

    if len(shape) == 0 or max(shape) == 1:
        return P()
    if len(shape) == 1:
        # vectors: shard over model when large & divisible (e.g. MoE biases)
        if shape[0] >= 8192 and _divisible(shape[0], n_model):
            return P(rules.model)
        return P()

    # embedding tables: vocab dim -> model (column-parallel unembed), d
    # replicated (FSDP on d would partial-sum the logits over data)
    if "embed" in name or "unembed" in name:
        spec = [None] * len(shape)
        vocab_dim = int(np.argmax(shape))
        if _divisible(shape[vocab_dim], n_model):
            spec[vocab_dim] = rules.model
        return P(*spec)

    # MoE expert stacks: (E, d_in, d_out)
    if len(shape) == 3 and ("mlp" in name or "expert" in name):
        E = shape[0]
        spec = [None, None, None]
        leaf = str(path[-1]) if path else ""
        if _divisible(E, n_model):
            spec[0] = rules.model      # expert parallelism
            if fsdp:
                big = 1 + int(shape[2] > shape[1])
                if _divisible(shape[big], n_data):
                    spec[big] = rules.data
        else:
            # Megatron pairing inside each expert: in-projections
            # column-parallel (f on model), out-projection row-parallel
            out_dim = 1 if leaf in ("w_down", "w_out") else 2
            in_dim = 3 - out_dim
            if _divisible(shape[out_dim], n_model):
                spec[out_dim] = rules.model
            if fsdp and _divisible(shape[in_dim], n_data):
                spec[in_dim] = rules.data
        return P(*spec)

    # other ≥3-D tensors (LoRA stacks, conv filters): largest divisible dim
    # on model, second on data
    if len(shape) != 2:
        spec = [None] * len(shape)
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        if _divisible(shape[order[0]], n_model) and shape[order[0]] >= 128:
            spec[order[0]] = rules.model
        if fsdp and len(order) > 1 and \
                _divisible(shape[order[1]], n_data) and \
                shape[order[1]] >= 128:
            spec[order[1]] = rules.data
        return P(*spec)

    # generic matrices — Megatron pairing: project-in weights are
    # column-parallel (output dim on `model`), project-out weights are
    # row-parallel (input dim on `model`): one activation all-reduce per
    # attention/MLP block
    leaf = str(path[-1]) if path else ""
    attn_leaf = ("attn" in name) and leaf in ("w_q", "w_k", "w_v", "w_o")
    if attn_leaf and not attn_tp:
        # heads don't divide the model axis: FSDP-only attention
        # projections
        spec = [None, None]
        if fsdp:
            io_dim = 0 if leaf != "w_o" else 1    # the d_model side
            if _divisible(shape[io_dim], n_data):
                spec[io_dim] = rules.data
        return P(*spec)
    if leaf in ("w_o", "w_down", "w_out", "w_v" if "cm" in name else "_"):
        big = 0        # row-parallel: contract dim on model
    elif leaf in ("w_q", "w_k", "w_up", "w_gate", "w_r", "w_g", "w_in",
                  "w_uq", "w_uk", "w_uv", "w_dq", "w_dkv") or \
            leaf == "w_v":
        big = 1        # column-parallel: output dim on model
    else:
        big = int(np.argmax(shape))
    small = 1 - big
    spec = [None, None]
    if _divisible(shape[big], n_model):
        spec[big] = rules.model
    if fsdp and _divisible(shape[small], n_data):
        spec[small] = rules.data
    return P(*spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(path, tree)


def params_specs(params_shape: Any, rules: ShardingRules, mesh,
                 stacked_layers: bool = True, fsdp: bool = True,
                 attn_tp: bool = True) -> Any:
    """PartitionSpec tree for the whole parameter dict (leaves: anything
    with a ``.shape`` — tensors, ``meta`` tensors).

    The port's ``blocks`` list gives each layer's leaf its spec (the list
    index is not part of the path).  A ``blocks`` subtree stacked on a
    leading L axis, as the JAX package's, keeps that axis unsharded when
    ``stacked_layers``.
    """
    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        if path and path[0] == "blocks":
            keys = tuple(k for k in path if not isinstance(k, int))
            if isinstance(params_shape.get("blocks"), (list, tuple)):
                return param_spec(keys, shape, rules, mesh, fsdp, attn_tp)
            if stacked_layers and shape:
                inner = param_spec(keys, shape[1:], rules, mesh, fsdp,
                                   attn_tp)
                return P(None, *inner)
            return param_spec(keys, shape, rules, mesh, fsdp, attn_tp)
        return param_spec(path, shape, rules, mesh, fsdp, attn_tp)

    return _map_with_path(spec_for, params_shape)


def batch_spec(rules: ShardingRules) -> P:
    """Token batches: (B, S) or (B, S, d) — batch over (pod, data)."""
    return P(rules.batch_axes)


def activation_spec(rules: ShardingRules) -> P:
    """Activations (B, S, d): batch over (pod, data), the rest whole."""
    return P(rules.batch_axes, None, None)


def kv_cache_spec(rules: ShardingRules, cfg: ArchConfig, mesh,
                  batch: int, seq_shard: bool = False) -> P:
    """KV caches (L, B, S, H, d): batch over data, heads over model.
    ``seq_shard=True`` (long contexts, batch=1): shard S over data
    instead — sequence parallelism for the cache."""
    n_model = mesh_axis_size(mesh, rules.model)
    heads_ok = _divisible(cfg.num_kv_heads, n_model)
    if seq_shard:
        return P(None, None, rules.data, rules.model if heads_ok else None,
                 None)
    return P(None, rules.batch_axes, None,
             rules.model if heads_ok else None, None)


def decode_state_specs(state_shape: Any, rules: ShardingRules,
                       cfg: ArchConfig, mesh,
                       seq_shard: bool = False) -> Any:
    """Specs for the decode caches (each with a leading stacked-layer
    axis) and the write index."""
    n_model = mesh_axis_size(mesh, rules.model)
    n_data = mesh_axis_size(mesh, rules.data)

    def spec_for(_path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0:
            return P()
        spec = [None] * len(shape)
        if len(shape) >= 2:
            batch_dim = 1
            if seq_shard and len(shape) >= 3:
                # shard the longest non-layer dim (the sequence) over data
                seq_dim = int(np.argmax(shape[1:])) + 1
                if _divisible(shape[seq_dim], n_data):
                    spec[seq_dim] = rules.data
            elif _divisible(shape[batch_dim],
                            mesh_axis_size(mesh, rules.data)
                            * mesh_axis_size(mesh, rules.pod)):
                spec[batch_dim] = rules.batch_axes
            # shard the LARGEST remaining divisible dim over model
            cand = sorted(range(2, len(shape)), key=lambda i: -shape[i])
            for dim in cand:
                if spec[dim] is None and _divisible(shape[dim], n_model) \
                        and shape[dim] >= n_model:
                    spec[dim] = rules.model
                    break
        return P(*spec)

    return _map_with_path(spec_for, state_shape)


def named(mesh, spec_tree: Any) -> Any:
    """Bind a tree of ``PartitionSpec``s to ``mesh``: each becomes its
    DTensor placements, one per mesh dim."""
    if isinstance(spec_tree, PartitionSpec):
        return placements(mesh, spec_tree, len(spec_tree))
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        vals = [named(mesh, v) for v in spec_tree]
        return type(spec_tree)(*vals) if hasattr(spec_tree, "_fields") \
            else type(spec_tree)(vals)
    return spec_tree


def distribute(tree: Any, mesh, spec_tree: Any) -> Any:
    """Every tensor leaf of ``tree`` — the whole value, held alike by every
    rank — as a DTensor on ``mesh`` placed by the ``PartitionSpec`` at the
    same place of ``spec_tree`` (a tree shaped like ``tree``; a ``None``
    subtree leaves its subtree as it is).  Each rank keeps its own slice,
    a contiguous copy; no collective runs."""
    from repro_torch import _dtensor
    if spec_tree is None or tree is None:
        return tree
    if isinstance(spec_tree, PartitionSpec):
        return _dtensor.shard(tree, mesh,
                              placements(mesh, spec_tree, tree.ndim))
    if isinstance(tree, dict):
        return {k: distribute(v, mesh, spec_tree[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [distribute(v, mesh, s) for v, s in zip(tree, spec_tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    raise TypeError(f"distribute: no spec for the leaf {tree!r}")
