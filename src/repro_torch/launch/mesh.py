"""Mesh builders of the PyTorch port (``torch.distributed``).

Counterpart of ``repro.launch.mesh``.  JAX runs one process that sees
every device; ``torch.distributed`` runs one process per rank, each in a
process group, and a mesh is a ``DeviceMesh`` over the group's ranks with
named dims.  Importing this module touches no process group.

The group: ``make_solve_mesh`` and ``make_host_mesh`` use the process
group that exists.  When none does and ``WORLD_SIZE`` is unset or 1, they
start a single-rank group themselves — NCCL for ``cuda``, gloo for
``cpu`` (never gloo on the card) — over a file store in a fresh temporary
file, so that concurrent test processes do not contend for a port.  Under
``torchrun`` (``WORLD_SIZE`` above 1 with ``RANK`` and ``MASTER_ADDR``
set) they start the ``env://`` group of the job, with the same backend
rule (on ``cuda`` each rank takes the card ``LOCAL_RANK``).  With
``WORLD_SIZE`` above 1 and neither a group nor that environment they
raise: a multi-rank job starts its group itself, with its address, world
size and rank (``torch.distributed.init_process_group``).  A group
started here is destroyed at exit if its caller has not destroyed it.  ``make_production_mesh``
raises unless the world holds its 256 (512) ranks, as the JAX package's
does without the devices.

Entry points take ``device=`` (``None``: ``cuda``, per
``repro_torch._device``).
"""
from __future__ import annotations

import atexit
import os
import tempfile

import torch

from repro_torch import _device


def _world_size() -> int:
    """Ranks in the running group, or the ``WORLD_SIZE`` the launcher set
    (1 when neither exists)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE") or 1)


def _ensure_group(dev: torch.device) -> None:
    """Start a single-rank process group when none exists (see the module
    docstring); raise where a multi-rank job has not started its own."""
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("this PyTorch build has no torch.distributed")
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE") or 1)
    launched = world > 1 and "RANK" in os.environ and \
        "MASTER_ADDR" in os.environ
    if world > 1 and not launched:
        raise RuntimeError(
            f"WORLD_SIZE={world} but no process group is running: start it "
            "with torch.distributed.init_process_group(init_method, "
            "world_size, rank) before building a mesh")
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh on cuda needs the NCCL backend, "
                               "which this PyTorch build lacks")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              if launched else dev.index or 0)
        backend = "nccl"
    else:
        backend = "gloo"
    path = None
    if launched:                     # torchrun's env:// rendezvous
        dist.init_process_group(backend, init_method="env://")
    else:
        fd, path = tempfile.mkstemp(prefix="repro_torch_group_")
        os.close(fd)
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                rank=0, world_size=1)
    group = dist.group.WORLD

    def close():
        # a NCCL group left open makes the process wait minutes at exit
        # for its heartbeat monitor, which reads the store's file
        if dist.is_initialized() and dist.group.WORLD is group:
            dist.destroy_process_group()
        if path is not None and os.path.exists(path):
            os.unlink(path)

    atexit.register(close)
    _OWN_GROUP.append(close)


# close() of the single-rank group ``_ensure_group`` started, while it runs
_OWN_GROUP: list = []


def _release_own_group() -> None:
    """Destroy the single-rank group this module started, if one runs (a
    caller that needed a mesh only for one call ends what it started)."""
    while _OWN_GROUP:
        _OWN_GROUP.pop()()


def _mesh(dev: torch.device, shape, names):
    """A ``DeviceMesh`` over the first prod(shape) ranks of the group
    (checked against the world before any group is started)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= int(s)
    have = _world_size()
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    _ensure_group(dev)
    ranks = torch.arange(n).reshape(tuple(int(s) for s in shape))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(data=16, model=16) over 256 ranks; multi-pod (pod=2, data=16,
    model=16) over 512, the ``pod`` axis pure data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if _world_size() != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {need} ranks; the world holds "
                         f"{_world_size()}")
    return _mesh(_device.resolve(device), shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """Small (data, model) mesh over the group's first data·model ranks."""
    return _mesh(_device.resolve(device), (data, model), ("data", "model"))


def auto_mesh_size(B: int, d: int, *, spd: bool = True,
                   dtype: str = "float32", max_devices: int = None) -> int:
    """The cost-model-selected 1-D solve-mesh extent for a (B, d) regime.

    Front end over ``analysis.autotune.auto_mesh_size``: candidates are
    power-of-two extents dividing ``B`` up to the world size (or
    ``max_devices``), ranked by measured tuning-cache entries when any
    exist and by the roofline solve model otherwise.  Pair with
    ``make_solve_mesh``::

        n = auto_mesh_size(B, d)
        mesh = make_solve_mesh(devices=n)

    On one card this gives 1, and a batch placed on a mesh of one runs
    ``sharded_cg``'s masked loop, not the batched-CG kernel: the
    ``cg``/``pallas_cg`` → ``sharded_cg`` upgrade follows the JAX package.
    A sharded ridge hypergradient at (64, 1024, 512) float32 took
    6.06–7.70× the unplaced one on an H100 80GB HBM3 at 700 W
    (``chip_smoke.py`` phase 24).  Where n is 1, leave the batch unplaced.
    """
    from repro_torch.analysis import autotune
    cap = _world_size() if max_devices is None else int(max_devices)
    return autotune.auto_mesh_size(B, d, spd=spd, dtype=dtype,
                                   max_devices=cap)


def make_solve_mesh(devices: int = None, axis: str = "data", *,
                    device=None):
    """1-D mesh for sharded linear solves (``ShardedOperator`` and the
    ``sharded_*`` registry solvers).

    Spans the group's first ``devices`` ranks (all by default).  Batched
    hypergradient workloads shard the instance batch over this axis;
    ``devices`` must then divide the batch size.  On a mesh of one the
    batch does not reach the batched-CG kernel (see ``auto_mesh_size``).
    """
    dev = _device.resolve(device)
    n = _world_size() if devices is None else int(devices)
    return _mesh(dev, (n,), (axis,))
