"""Operation census of one call: FLOPs, bytes and collective bytes.

Counterpart of ``repro.analysis.hlo``.  The JAX package parses the
compiled HLO text of a program and multiplies loop bodies by trip counts
parsed from the loop conditions.  PyTorch runs eagerly and has no such
text, so the port counts the operations themselves: :class:`Census` is a
``TorchDispatchMode`` that sees every aten operation of one call of a
function, below autograd and ``torch.func``'s decompositions of
composite operations.  Loops are counted by running them, so no trip
count is parsed.

Cost model (per aten operation, the shapes of this call):
  * matrix products — ``mm``, ``bmm``, ``addmm``, ``baddbmm``:
    2 · numel(out) · K, K the contracted extent (the reference's
    ``_dot_flops``); ``convolution``: 2 · numel(out) · numel(weight) /
    C_out (its ``_conv_flops``; a transposed convolution counts per input
    element).  No other operation counts FLOPs, as in the reference.
  * bytes: every operation's tensor operands plus its tensor outputs.
    Eager PyTorch fuses nothing, so every operation is its own fusion
    boundary — where XLA's fusions keep their internals on chip, the
    census counts each elementwise operation's traffic.  Views and
    uninitialized allocations move no data and count nothing; a stride-0
    (broadcast) axis counts once.
  * collectives: the operand bytes of the ``c10d`` functional
    collectives (all-reduce, all-gather, reduce-scatter, all-to-all); the
    port issues none before the distributed slice (ROADMAP A.11).
  * a hand-written kernel's launch goes through ``ctypes`` and is
    invisible to the dispatcher.  Each kernel's ``ops.py`` calls
    :func:`record_custom_call` at its launch: its operands' and outputs'
    bytes, no FLOPs, and one more in ``custom_calls[name]`` — the
    reference's HLO analyzer counts a custom call's bytes as nothing.
    The call does nothing when no census is active.

``analyze_module(fn, *args, **kwargs)``, ``collective_bytes`` and
``collective_op_counts`` take a callable and its arguments where the
reference takes HLO text.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# c10d collective names -> the reference's collective kinds
_C10D = (("all_gather", "all-gather"), ("allgather", "all-gather"),
         ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
         ("reduce_scatter", "reduce-scatter"),
         ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))
_C10D_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# operations that move no data but are not declared views (a reshape's
# ``_unsafe_view`` aliases its input; an allocation reads nothing and
# leaves its memory unwritten): counted as nothing
_NO_DATA = {"_unsafe_view", "lift_fresh", "empty", "empty_like",
            "empty_strided", "new_empty", "new_empty_strided"}


@dataclasses.dataclass
class Costs:
    """What one call cost: the reference's fields, plus ``custom_calls``
    (launches of hand-written kernels by name) and ``flops_by_op``."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_ops: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    custom_calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    flops_by_op: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))

    def add(self, other: "Costs", mult: float = 1.0):
        """Accumulate ``other`` × ``mult`` into this record."""
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        for k, v in other.per_collective.items():
            self.per_collective[k] += v * mult
        for k, v in other.collective_ops.items():
            self.collective_ops[k] += int(v * mult)
        for k, v in other.custom_calls.items():
            self.custom_calls[k] += int(v * mult)
        for k, v in other.flops_by_op.items():
            self.flops_by_op[k] += v * mult

    def cost_dict(self) -> Dict[str, float]:
        """``{"flops", "bytes accessed"}``, what ``roofline.analyze``
        takes."""
        return {"flops": self.flops, "bytes accessed": self.hbm_bytes}


def _tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements, a stride-0 (broadcast) axis once."""
    if t.numel() == 0:
        return 0
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _bytes_of(tree) -> int:
    return sum(_tensor_bytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _product_flops(name: str, args, out) -> float:
    """The reference's dot / convolution FLOPs of one aten operation."""
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * args[1].shape[-1]
    if name == "convolution":
        x, w = args[0], args[1]
        transposed = bool(args[6] if len(args) > 6 else False)
        if transposed:      # weight (C_in, C_out / groups, *k)
            return 2.0 * x.numel() * (w.numel() // w.shape[0])
        return 2.0 * out.numel() * (w.numel() // w.shape[0])
    return 0.0


def _collective_kind(func) -> str:
    if func.namespace not in _C10D_NAMESPACES:
        return ""
    name = func._schema.name.split("::")[-1]
    for fragment, kind in _C10D:
        if fragment in name:
            return kind
    return ""


_ACTIVE = threading.local()


def _active() -> list:
    if not hasattr(_ACTIVE, "stack"):
        _ACTIVE.stack = []
    return _ACTIVE.stack


class Census(TorchDispatchMode):
    """Count the aten operations run inside ``with Census() as c:`` into
    ``c.costs`` (see the module docstring for the cost model)."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()

    def __enter__(self):
        _active().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active().remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.is_view or name in _NO_DATA:
            return out
        c = self.costs
        moved = _bytes_of((args, kwargs)) + _bytes_of(out)
        kind = _collective_kind(func)
        if kind:
            sent = _bytes_of(args[0])
            c.collective_bytes += sent
            c.per_collective[kind] += sent
            c.collective_ops[kind] += 1
        flops = _product_flops(name, args, out)
        if flops:
            c.flops += flops
            c.flops_by_op[f"aten.{name}"] += flops
        c.hbm_bytes += moved
        return out


def record_custom_call(name: str, inputs, outputs) -> None:
    """Record one launch of the hand-written kernel ``name`` in every
    active census: the bytes of its ``inputs`` and ``outputs`` (tensors or
    pytrees of them), no FLOPs.  Does nothing when no census is active."""
    stack = _active()
    if not stack:
        return
    moved = _bytes_of(inputs) + _bytes_of(outputs)
    for census in stack:
        census.costs.hbm_bytes += moved
        census.costs.custom_calls[name] += 1


def analyze_module(fn: Callable, *args, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` once under a :class:`Census` and return
    what it cost."""
    with Census() as census:
        fn(*args, **kwargs)
    return census.costs


# -- the reference's helpers, on a callable ---------------------------------

def collective_bytes(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Collective bytes of one call by kind, and their ``"total"``."""
    c = analyze_module(fn, *args, **kwargs)
    out = {k: int(v) for k, v in c.per_collective.items()}
    out["total"] = int(c.collective_bytes)
    return out


def collective_op_counts(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Collective operations of one call by kind."""
    return dict(analyze_module(fn, *args, **kwargs).collective_ops)
