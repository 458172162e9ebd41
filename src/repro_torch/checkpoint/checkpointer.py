"""Fault-tolerant checkpointing in the reference's file format.

Counterpart of ``repro/checkpoint/checkpointer.py``, with its properties:

  * **atomic**: write to ``step_K.tmp`` then rename — a crash mid-write
    never corrupts the latest checkpoint;
  * **keep-N** garbage collection;
  * **async**: the file write runs on a background thread (``wait()``
    joins it before exit and before the next save);
  * **multi-host layout**: each host writes its shards under ``host_<i>/``
    (one host here), plus a JSON manifest for restore-time validation.

**The format is the reference's**, so each package reads the other's
checkpoints: one ``host_<i>/shards.npz`` per step, its keys named as
``jax.tree_util.tree_flatten_with_path`` names the reference's tree
(``.params/blocks/attn/w_q``, ``.opt_state/step``, ``.opt_state/mu/...``:
a named tuple's field as ``.name``, a dict key as itself, a sequence index
as its number, ``None`` as nothing), the port's ``blocks`` lists of
per-layer dicts stacked on a leading L axis (the reference's layout), and
bfloat16 widened to float32 (``npz`` has no bfloat16; ``restore`` casts
back to the target's type).

On a mesh the state's leaves are DTensors.  ``save`` gathers each one
whole (``full_tensor``, a collective: every rank of the mesh calls
``save`` with the same tree) and global rank 0 alone writes, so the file
is the reference's, full arrays and one writer, whatever the mesh.
``restore`` into a DTensor target has every rank read the file and copy
its own shard of each array into the target's local tensor, so a
checkpoint written on one mesh restores on any other (the elastic
restart: saved on 4 × 2 ranks, restored on 2 × 2).

Differences of form: ``save`` copies every tensor to host memory on the
calling thread before it returns (the train step updates its state in
place, so the background writer must not read the live tensors), and
``restore`` copies into the target's tensors in place where they hold
storage (a tensor on ``meta`` comes back as a new CPU tensor; a tensor
that stands for more than one leaf of the target, as a solver state's
zero moments may, as a new tensor for each; a Python number or numpy
array as a new one of its type).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed

from repro_torch._dtensor import full, is_dtensor, local_slice, shard


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(name, child) pairs of a tree node, named as the reference's key
    paths; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaves(tree, parts=(), layer=None):
    """Yield ``(key, layer, leaf)`` for every leaf; ``layer`` is the index
    of a leaf under a ``blocks`` list (stacked in the file), else None."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(parts), layer, tree
        return
    for name, child in kids:
        if name == "blocks" and isinstance(child, list) and layer is None:
            for i, block in enumerate(child):
                yield from _leaves(block, parts + (name,), i)
        else:
            yield from _leaves(child, parts + (name,), layer)


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` as numpy, bfloat16 widened to float32 (a
    DTensor gathered whole first)."""
    if isinstance(leaf, torch.Tensor):
        t = full(leaf.detach()).to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    arr = np.array(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Any):
    out, layers = {}, {}
    for key, layer, leaf in _leaves(tree):
        if layer is None:
            out[key] = _host(leaf)
        else:
            layers.setdefault(key, []).append(_host(leaf))
    for key, parts in layers.items():
        out[key] = np.stack(parts)
    return out


def _restored(tree, data, shared, parts=(), layer=None):
    """``tree`` with every leaf read from ``data`` (see the module
    docstring); shapes checked against the target's.  Tensors whose id is
    in ``shared`` stand for more than one leaf: each such leaf gets a new
    tensor."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        key = "/".join(parts)
        arr = data[key]
        if layer is not None:
            arr = arr[layer]
        shape = tuple(tree.shape) if hasattr(tree, "shape") else ()
        if tuple(arr.shape) != shape:
            where = key if layer is None else f"{key}[{layer}]"
            raise ValueError(f"checkpoint/model shape mismatch at {where}: "
                             f"{arr.shape} vs {shape}")
        if is_dtensor(tree):
            src = local_slice(torch.from_numpy(np.asarray(arr)),
                              tree.device_mesh, tree.placements)
            if id(tree) in shared:
                return shard(torch.from_numpy(np.asarray(arr)).to(
                    device=tree.device, dtype=tree.dtype),
                    tree.device_mesh, tree.placements)
            with torch.no_grad():
                tree.to_local().copy_(src)
            return tree
        if isinstance(tree, torch.Tensor):
            src = torch.from_numpy(np.asarray(arr))
            if tree.device.type == "meta":
                return src.to(tree.dtype)
            if id(tree) in shared:
                return src.to(device=tree.device, dtype=tree.dtype)
            with torch.no_grad():
                tree.copy_(src)
            return tree
        if isinstance(tree, np.ndarray):
            return arr.astype(tree.dtype)
        return type(tree)(arr)
    values = []
    for name, child in kids:
        if name == "blocks" and isinstance(child, list) and layer is None:
            values.append([_restored(b, data, shared, parts + (name,), i)
                           for i, b in enumerate(child)])
        else:
            values.append(_restored(child, data, shared, parts + (name,),
                                    layer))
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if _is_namedtuple(tree):
        return type(tree)(*values)
    return type(tree)(values)


class CheckpointManager:

    def __init__(self, directory: str, keep: int = 3, host_id: int = 0,
                 num_hosts: int = 1):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False):
        """Snapshot ``tree`` at ``step``: copied to host memory here, the
        file written on a background thread unless ``blocking``.  A tree
        of DTensors is gathered here on every rank and written by global
        rank 0 alone."""
        self.wait()
        arrays = _flatten(tree)
        if any(is_dtensor(leaf) for _, _, leaf in _leaves(tree)) and \
                torch.distributed.get_rank() != 0:
            return

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(os.path.join(tmp, f"host_{self.host_id}"),
                        exist_ok=True)
            np.savez(os.path.join(tmp, f"host_{self.host_id}",
                                  "shards.npz"), **arrays)
            manifest = {
                "step": step,
                "num_hosts": self.num_hosts,
                "keys": sorted(arrays.keys()),
                "shapes": {k: list(v.shape) for k, v in arrays.items()},
                "time": time.time(),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, final)           # atomic publish
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any) -> Any:
        """Restore into the structure of ``target`` (shapes validated,
        values cast to each target leaf's type; see the module docstring
        for where they land)."""
        path = os.path.join(self.dir, f"step_{step}",
                            f"host_{self.host_id}", "shards.npz")
        seen, shared = set(), set()
        for _, _, leaf in _leaves(target):
            if isinstance(leaf, torch.Tensor):
                (shared if id(leaf) in seen else seen).add(id(leaf))
        with np.load(path) as npz:      # each array read once: a blocks
            data = {k: npz[k] for k in npz.files}   # leaf is read per layer
        return _restored(target, data, shared)

    def restore_latest(self, target: Any):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target)
