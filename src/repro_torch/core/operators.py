"""Pytree-native linear operators: the shared matvec abstraction (PyTorch).

Counterpart of ``repro.core.operators``.  The implicit-diff system
``A = -∂₁F(x*, θ)`` is known only through matrix-vector products; this
module makes that object first class so that symmetry, definiteness and
dense access travel with it:

  * ``LinearOperator`` — the protocol: ``matvec`` / ``rmatvec`` /
    ``transpose()`` (``.T``) / ``diagonal()`` / ``materialize()`` /
    ``ravel_view()``, plus ``symmetric`` / ``positive_definite`` flags and
    ``batch_ndim`` batch-axis awareness.
  * ``JacobianOperator`` — ``∂f(x)`` (optionally negated), with ``matvec``
    a ``torch.func.jvp`` and ``rmatvec`` a ``torch.func.vjp``.
  * ``DenseOperator`` — an explicit ``(d, d)`` or batched ``(B, d, d)``
    matrix acting on pytrees through a ravel.
  * ``SampledJacobianOperator`` — ``E_b[∂₁f(x₀, b)]`` estimated by
    averaging one JVP per resample batch (a ``torch.func.vmap`` of
    ``torch.func.jvp`` over the resample axis).
  * ``RidgeShifted`` — ``A + λI`` damping that preserves structure.
  * ``BlockDiagonal`` — independent blocks over a tuple of sub-domains;
    the source of block-Jacobi preconditioners.
  * ``ComposedOperator`` — ``outer ∘ inner`` products.
  * ``RaveledOperator`` (``raveled()``) — an operator on its raveled flat
    vector domain.
  * ``FunctionOperator`` / ``TransposedOperator`` / ``as_operator`` and
    the Jacobi and block-Jacobi preconditioners.

Defaults are matrix-free: ``rmatvec`` is the VJP of ``matvec`` (the
transpose of a linear map), or ``matvec`` itself under declared symmetry;
``diagonal()`` / ``materialize()`` probe with basis vectors through
``torch.func.vmap`` (``d`` matvecs in one batched call).  Structured
operators answer in O(1).

Pytrees are ``torch.utils._pytree`` trees whose dicts flatten in sorted
key order, as in JAX (see ``repro_torch.core._tree``), so raveled vectors
and materialized matrices line up with the JAX package's.

This module imports nothing else of the package.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.func

from repro_torch.core._tree import (canonical, ravel_batched, ravel_pytree,
                                    tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)


def _ravel1(tree) -> torch.Tensor:
    """Ravel one instance-shaped pytree to a flat vector."""
    return ravel_pytree(tree)[0]


def _tree_add_scaled(a, b, alpha):
    return tree_map(lambda x, y: x + alpha * y, a, b)


# ---------------------------------------------------------------------------
# flat (B, d) view of a (possibly batched) operator
# ---------------------------------------------------------------------------

class RavelView(NamedTuple):
    """Batched flat representation: leaves ``(B, ...)`` <-> matrix ``(B, d)``.

    Unbatched calls get a synthetic ``B = 1`` axis (``batched=False``), so
    the dense-regime solver cores run one uniform ``(B, d)`` layout.
    """
    mv: Callable          # (B, d) -> (B, d)
    b: torch.Tensor       # (B, d) raveled right-hand side
    to_tree: Callable     # (B, d) -> (batched) pytree
    batched: bool         # whether the original call was batch_ndim == 1


def ravel_view(matvec: Callable, b, batch_ndim: int = 0) -> RavelView:
    """The single flat view of an operator: ``matvec`` on raveled vectors.

    ``matvec`` may be a bare callable or a ``LinearOperator``; ``b``
    supplies the domain structure and the raveled right-hand side.
    """
    if batch_ndim == 0:
        b_flat, unravel = ravel_pytree(b)

        def mv(vf):  # (1, d) -> (1, d)
            return _ravel1(matvec(unravel(vf[0])))[None]

        return RavelView(mv, b_flat[None], lambda xf: unravel(xf[0]), False)

    b_flat, unravel = ravel_batched(b)

    def mv(vf):  # (B, d) -> (B, d)
        return ravel_batched(matvec(unravel(vf)))[0]

    return RavelView(mv, b_flat, unravel, True)


def _basis_probe(view: RavelView) -> torch.Tensor:
    """``(d, B, d)`` stack of ``A e_i`` for every basis vector ``e_i``,
    one ``torch.func.vmap`` over the probing index."""
    B, d = view.b.shape
    eye = torch.eye(d, dtype=view.b.dtype, device=view.b.device)
    return torch.func.vmap(
        lambda e: view.mv(e.expand(B, d)))(eye)              # (d, B, d)


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------

class LinearOperator:
    """A linear map over a pytree domain, known through matvecs + metadata.

    Attributes:
      example: an instance of the domain pytree (batched leaves when
        ``batch_ndim == 1``) — the structural witness every ravel-based
        default needs.
      batch_ndim: 0 for one system, 1 when every leaf carries a leading
        batch axis of independent systems.
      symmetric: ``True`` (A = Aᵀ per instance), ``False`` (known general),
        or ``None`` (unknown — routing trusts the caller's solver choice).
      positive_definite: ``True`` asserts per-instance SPD.

    Subclasses implement ``matvec``; everything else has matrix-free
    defaults.  Operators are callable (``A(v) == A.matvec(v)``).
    """

    is_sharded = False

    def __init__(self, example, *, batch_ndim: int = 0,
                 symmetric: Optional[bool] = None,
                 positive_definite: bool = False):
        if batch_ndim not in (0, 1):
            raise ValueError(f"batch_ndim must be 0 or 1, got {batch_ndim}")
        if positive_definite and symmetric is False:
            raise ValueError("positive_definite=True asserts symmetry; "
                             "symmetric=False contradicts it")
        self.example = canonical(example)
        self.batch_ndim = batch_ndim
        self.symmetric = True if positive_definite else symmetric
        self.positive_definite = positive_definite

    # -- core ------------------------------------------------------------
    def matvec(self, v):
        """Apply the operator to ``v`` (pytree → pytree)."""
        raise NotImplementedError

    def __call__(self, v):
        return self.matvec(v)

    def rmatvec(self, v):
        """Aᵀ v.  Symmetric operators reuse ``matvec``; the general default
        is the VJP of the (linear) matvec, i.e. its transpose."""
        if self.symmetric:
            return self.matvec(v)
        zeros = tree_map(torch.zeros_like, self.example)
        _, vjp_fun = torch.func.vjp(lambda u: canonical(self.matvec(u)),
                                    zeros)
        (out,) = vjp_fun(canonical(v))
        return out

    def transpose(self) -> "LinearOperator":
        """Aᵀ as an operator (``self`` when symmetry is declared)."""
        if self.symmetric:
            return self
        return TransposedOperator(self)

    @property
    def T(self) -> "LinearOperator":
        """The transposed operator (alias for ``transpose()``)."""
        return self.transpose()

    # -- structure access (matrix-free probing defaults) -----------------
    def ravel_view(self, b=None) -> RavelView:
        """The flat ``(B, d)`` view of this operator (``b`` defaults to the
        structural example)."""
        return ravel_view(self.matvec, self.example if b is None else b,
                          self.batch_ndim)

    def _instance_dim(self) -> int:
        example = self.example
        if self.batch_ndim:
            example = tree_map(lambda l: l[0], example)
        return _ravel1(example).shape[0]

    def diagonal(self):
        """diag(A) with the domain's structure (default: ``d`` probing
        matvecs, batched across instances)."""
        view = self.ravel_view()
        cols = _basis_probe(view)                               # (d, B, d)
        diag = torch.diagonal(cols, dim1=0, dim2=2)             # (B, d)
        return view.to_tree(diag)

    def materialize(self) -> torch.Tensor:
        """The dense matrix: ``(d, d)`` unbatched, ``(B, d, d)`` batched.

        Default probes with basis vectors broadcast across the batch, so
        the cost is ``d`` matvecs regardless of batch size; structured
        operators override with O(1) access.
        """
        view = self.ravel_view()
        A = _basis_probe(view).permute(1, 2, 0)                 # A[b][:, i]
        return A if self.batch_ndim else A[0]

    def raveled(self) -> "RaveledOperator":
        """This operator re-expressed on the raveled flat vector domain."""
        return RaveledOperator(self)

    def __repr__(self):
        flags = []
        if self.symmetric:
            flags.append("symmetric")
        if self.positive_definite:
            flags.append("PD")
        if self.batch_ndim:
            flags.append("batched")
        return (f"{type(self).__name__}(d={self._instance_dim()}"
                + (", " + ",".join(flags) if flags else "") + ")")


class TransposedOperator(LinearOperator):
    """Aᵀ of a wrapped square operator; its transpose is the original."""

    def __init__(self, op: LinearOperator):
        super().__init__(op.example, batch_ndim=op.batch_ndim,
                         symmetric=op.symmetric,
                         positive_definite=op.positive_definite)
        self.op = op

    def matvec(self, v):
        """Apply ``Aᵀ`` (the base operator's ``rmatvec``)."""
        return self.op.rmatvec(v)

    def rmatvec(self, v):
        """Apply ``A`` (the base operator's ``matvec``)."""
        return self.op.matvec(v)

    def transpose(self) -> LinearOperator:
        """The original operator back."""
        return self.op


# ---------------------------------------------------------------------------
# concrete operators
# ---------------------------------------------------------------------------

class FunctionOperator(LinearOperator):
    """Adapt a matvec closure (and optional rmatvec) to the protocol."""

    def __init__(self, matvec: Callable, example, *,
                 rmatvec: Optional[Callable] = None, batch_ndim: int = 0,
                 symmetric: Optional[bool] = None,
                 positive_definite: bool = False):
        super().__init__(example, batch_ndim=batch_ndim, symmetric=symmetric,
                         positive_definite=positive_definite)
        self._matvec = matvec
        self._rmatvec = rmatvec

    def matvec(self, v):
        """Apply the wrapped matvec callable."""
        return self._matvec(v)

    def rmatvec(self, v):
        """Apply the adjoint (supplied, or derived via ``torch.func.vjp``)."""
        if self._rmatvec is not None:
            return self._rmatvec(v)
        return super().rmatvec(v)


class JacobianOperator(LinearOperator):
    """``∂f(x₀)`` (optionally negated) of a pytree mapping ``f``.

    ``matvec`` is a ``torch.func.jvp`` at ``x₀`` and ``rmatvec`` a
    ``torch.func.vjp``: the implicit system ``A dx = b`` with
    ``A = -∂₁F(x*, θ)`` is
    ``JacobianOperator(lambda x: F(x, *theta), x_star, negate=True)``.
    ``symmetric=True`` certifies ``A = Aᵀ`` (``f`` a gradient mapping), so
    the cotangent system reuses the forward matvec.
    """

    def __init__(self, fun: Callable, primal, *, negate: bool = False,
                 batch_ndim: int = 0, symmetric: Optional[bool] = None,
                 positive_definite: bool = False):
        super().__init__(primal, batch_ndim=batch_ndim, symmetric=symmetric,
                         positive_definite=positive_definite)
        self.fun = fun
        self.primal = self.example
        self.negate = negate

    def _fun(self, x):
        return canonical(self.fun(x))

    def matvec(self, v):
        """Jacobian-vector product: JVP of the map at the primal point."""
        _, jv = torch.func.jvp(self._fun, (self.primal,), (canonical(v),))
        return tree_map(torch.neg, jv) if self.negate else jv

    def rmatvec(self, v):
        """Vector-Jacobian product: VJP of the map at the primal point."""
        if self.symmetric:
            return self.matvec(v)
        _, vjp_fun = torch.func.vjp(self._fun, self.primal)
        (out,) = vjp_fun(canonical(v))
        return tree_map(torch.neg, out) if self.negate else out


class SampledJacobianOperator(LinearOperator):
    """Monte-Carlo estimate of an expectation Jacobian ``E_b[∂₁f(x₀, b)]``.

    ``fun(x, batch)`` maps the domain pytree to itself for one minibatch
    (canonically a minibatch gradient mapping, whose Jacobian is a
    minibatch Hessian); ``batches`` is a pytree whose leaves carry a
    leading resample axis of length ``k``.  ``matvec`` is a
    ``torch.func.vmap`` of one ``torch.func.jvp`` per batch, averaged over
    the resample axis — an unbiased estimate of the full-batch product
    whose variance shrinks like ``1/k``, and the full-batch product itself
    when the ``k`` equal-sized batches partition the data.

    ``negate`` flips the sign (the implicit system solves against
    ``A = -∂₁F``); ``symmetric=True`` certifies every per-batch Jacobian
    symmetric, so the cotangent solve reuses ``matvec``.
    """

    def __init__(self, fun: Callable, primal, batches, *,
                 negate: bool = False, batch_ndim: int = 0,
                 symmetric: Optional[bool] = None,
                 positive_definite: bool = False):
        super().__init__(primal, batch_ndim=batch_ndim, symmetric=symmetric,
                         positive_definite=positive_definite)
        leaves = tree_leaves(batches)
        if not leaves:
            raise ValueError("batches must be a non-empty pytree whose "
                             "leaves carry a leading resample axis")
        self.fun = fun
        self.primal = self.example
        self.batches = canonical(batches)
        self.negate = negate
        self.num_samples = int(leaves[0].shape[0])

    def _mean(self, stacked):
        sign = -1.0 if self.negate else 1.0
        return tree_map(lambda leaf: sign * leaf.mean(dim=0), stacked)

    def matvec(self, v):
        """Resample-averaged JVP of the per-batch map at the primal."""
        v = canonical(v)

        def one(batch):
            _, jv = torch.func.jvp(lambda x: canonical(self.fun(x, batch)),
                                   (self.primal,), (v,))
            return jv

        return self._mean(torch.func.vmap(one)(self.batches))

    def rmatvec(self, v):
        """Resample-averaged VJP (``matvec`` under declared symmetry)."""
        if self.symmetric:
            return self.matvec(v)
        v = canonical(v)

        def one(batch):
            _, vjp_fun = torch.func.vjp(
                lambda x: canonical(self.fun(x, batch)), self.primal)
            return vjp_fun(v)[0]

        return self._mean(torch.func.vmap(one)(self.batches))


class DenseOperator(LinearOperator):
    """An explicit matrix ``(d, d)`` (or batched ``(B, d, d)``) acting on
    pytrees through a ravel.  ``diagonal``/``materialize`` are O(1)."""

    def __init__(self, A, example=None, *,
                 symmetric: Optional[bool] = None,
                 positive_definite: bool = False):
        A = torch.as_tensor(A)
        if A.ndim not in (2, 3) or A.shape[-1] != A.shape[-2]:
            raise ValueError(f"expected (d, d) or (B, d, d), got "
                             f"{tuple(A.shape)}")
        batch_ndim = 1 if A.ndim == 3 else 0
        d = A.shape[-1]
        if example is None:
            example = torch.zeros(A.shape[:-1], dtype=A.dtype,
                                  device=A.device)
        super().__init__(example, batch_ndim=batch_ndim, symmetric=symmetric,
                         positive_definite=positive_definite)
        self.A = A
        if self._instance_dim() != d:
            raise ValueError(f"example ravels to d={self._instance_dim()} "
                             f"but the matrix is {d}x{d}")

    def matvec(self, v):
        """Dense matvec ``A @ v`` (batched over ``batch_ndim``)."""
        view = ravel_view(lambda t: t, v, self.batch_ndim)  # structure only
        A = self.A if self.batch_ndim else self.A[None]
        return view.to_tree(torch.einsum("bij,bj->bi", A, view.b))

    def rmatvec(self, v):
        """Dense adjoint matvec ``Aᵀ @ u``."""
        if self.symmetric:
            return self.matvec(v)
        return DenseOperator(self.A.transpose(-1, -2),
                             self.example).matvec(v)

    def transpose(self) -> LinearOperator:
        """Operator over the transposed matrix (``self`` when symmetric)."""
        if self.symmetric:
            return self
        return DenseOperator(self.A.transpose(-1, -2), self.example,
                             symmetric=self.symmetric)

    def diagonal(self):
        """The matrix diagonal, O(1)."""
        diag = torch.diagonal(self.A, dim1=-2, dim2=-1)
        view = ravel_view(lambda t: t, self.example, self.batch_ndim)
        return view.to_tree(diag if self.batch_ndim else diag[None])

    def materialize(self) -> torch.Tensor:
        """The stored dense matrix itself, O(1)."""
        return self.A


class RidgeShifted(LinearOperator):
    """``A + λI``: structure-preserving damping.  Symmetry survives and
    definiteness survives; promoting a PSD base to SPD needs an explicit
    ``positive_definite=True``.  ``diagonal``/``materialize`` shift instead
    of re-probing."""

    def __init__(self, op: LinearOperator, ridge: float, *,
                 positive_definite: Optional[bool] = None):
        pd = op.positive_definite if positive_definite is None \
            else positive_definite
        super().__init__(op.example, batch_ndim=op.batch_ndim,
                         symmetric=op.symmetric, positive_definite=pd)
        self.op = op
        self.ridge = ridge

    def matvec(self, v):
        """Apply ``A + ridge·I``."""
        return _tree_add_scaled(self.op.matvec(v), v, self.ridge)

    def rmatvec(self, v):
        """Apply ``(A + ridge·I)ᵀ``."""
        return _tree_add_scaled(self.op.rmatvec(v), v, self.ridge)

    def transpose(self) -> LinearOperator:
        """Ridge shift of the transposed base operator."""
        if self.symmetric:
            return self
        return RidgeShifted(self.op.transpose(), self.ridge,
                            positive_definite=self.positive_definite)

    def diagonal(self):
        """Base diagonal plus ``ridge``."""
        return tree_map(lambda dg: dg + self.ridge, self.op.diagonal())

    def materialize(self) -> torch.Tensor:
        """Base matrix plus ``ridge·I``."""
        A = self.op.materialize()
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        return A + self.ridge * eye


class BlockDiagonal(LinearOperator):
    """Independent blocks over a tuple domain: ``A = diag(A₁, …, Aₖ)``.

    The domain is a tuple with one entry per block (each entry any
    pytree).  Symmetry/definiteness are the conjunction of the blocks';
    ``diagonal`` is the blocks' diagonals — the natural source of
    block-Jacobi preconditioners (``block_jacobi_preconditioner``).
    """

    def __init__(self, ops: Sequence[LinearOperator]):
        ops = tuple(ops)
        if not ops:
            raise ValueError("BlockDiagonal needs at least one block")
        batch = {op.batch_ndim for op in ops}
        if len(batch) != 1:
            raise ValueError("blocks disagree on batch_ndim")
        syms = [op.symmetric for op in ops]
        symmetric = (True if all(s is True for s in syms)
                     else False if any(s is False for s in syms) else None)
        super().__init__(tuple(op.example for op in ops),
                         batch_ndim=batch.pop(), symmetric=symmetric,
                         positive_definite=all(op.positive_definite
                                               for op in ops))
        self.ops = ops

    def matvec(self, v):
        """Apply each block to its entry of the domain tuple."""
        return tuple(op.matvec(vi) for op, vi in zip(self.ops, v))

    def rmatvec(self, v):
        """Apply each block's adjoint to its entry."""
        return tuple(op.rmatvec(vi) for op, vi in zip(self.ops, v))

    def transpose(self) -> LinearOperator:
        """Blockwise transpose."""
        if self.symmetric:
            return self
        return BlockDiagonal(tuple(op.transpose() for op in self.ops))

    def diagonal(self):
        """Blockwise diagonals as a pytree."""
        return tuple(op.diagonal() for op in self.ops)

    def materialize(self) -> torch.Tensor:
        """Dense block-diagonal matrix in ravel order."""
        blocks = [op.materialize() for op in self.ops]
        d = sum(blk.shape[-1] for blk in blocks)
        shape = blocks[0].shape[:-2] + (d, d)
        A = blocks[0].new_zeros(shape)
        i = 0
        for blk in blocks:
            n = blk.shape[-1]
            A[..., i:i + n, i:i + n] = blk
            i += n
        return A


class ComposedOperator(LinearOperator):
    """``outer ∘ inner`` — the product operator, e.g. a left-preconditioned
    system ``M⁻¹ A``.  Flags default to unknown (products rarely preserve
    them) unless asserted explicitly."""

    def __init__(self, outer: LinearOperator, inner: LinearOperator, *,
                 symmetric: Optional[bool] = None,
                 positive_definite: bool = False):
        super().__init__(inner.example, batch_ndim=inner.batch_ndim,
                         symmetric=symmetric,
                         positive_definite=positive_definite)
        self.outer = outer
        self.inner = inner

    def matvec(self, v):
        """Apply the composition right to left."""
        return self.outer.matvec(self.inner.matvec(v))

    def rmatvec(self, v):
        """Apply the adjoint composition left to right."""
        return self.inner.rmatvec(self.outer.rmatvec(v))

    def transpose(self) -> LinearOperator:
        """Compose the transposes in reverse order."""
        if self.symmetric:
            return self
        # (M A)ᵀ = Aᵀ Mᵀ; the declared flags are properties of the product
        return ComposedOperator(self.inner.transpose(),
                                self.outer.transpose(),
                                symmetric=self.symmetric,
                                positive_definite=self.positive_definite)


class RaveledOperator(LinearOperator):
    """An operator re-expressed on its raveled flat-vector domain.

    ``ravel``/``unravel`` move right-hand sides and solutions across, and
    ``ravel_fn`` lifts tree-to-tree callables (user preconditioners) to
    the flat domain.  Instance-shaped operators only.
    """

    def __init__(self, op: LinearOperator):
        if op.batch_ndim != 0:
            raise ValueError("RaveledOperator wraps instance-shaped "
                             "operators; torch.func.vmap supplies batching")
        flat_example, unravel = ravel_pytree(op.example)
        super().__init__(flat_example, batch_ndim=0, symmetric=op.symmetric,
                         positive_definite=op.positive_definite)
        self.op = op
        self._unravel = unravel

    def ravel(self, tree) -> torch.Tensor:
        """Ravel a domain pytree to the flat vector domain."""
        return _ravel1(tree)

    def unravel(self, flat):
        """Unravel a flat vector back to the domain pytree."""
        return self._unravel(flat)

    def ravel_fn(self, fn: Callable) -> Callable:
        """Lift a tree→tree linear map (e.g. a preconditioner) to flat."""
        return lambda vf: _ravel1(fn(self._unravel(vf)))

    def matvec(self, vf):
        """Flat-domain matvec (unravel → base matvec → ravel)."""
        return _ravel1(self.op.matvec(self._unravel(vf)))

    def rmatvec(self, vf):
        """Flat-domain adjoint matvec."""
        return _ravel1(self.op.rmatvec(self._unravel(vf)))

    def diagonal(self):
        """Base diagonal, raveled flat."""
        return _ravel1(self.op.diagonal())

    def materialize(self) -> torch.Tensor:
        """The base operator's dense matrix (already ravel-ordered)."""
        return self.op.materialize()

    def raveled(self) -> "RaveledOperator":
        """Already flat: ``self``."""
        return self


# ---------------------------------------------------------------------------
# adapters and derived preconditioners
# ---------------------------------------------------------------------------

def as_operator(obj, example=None, *, batch_ndim: int = 0,
                symmetric: Optional[bool] = None,
                positive_definite: bool = False) -> LinearOperator:
    """Coerce to a ``LinearOperator``.

    Operators pass through unchanged; a 2-D/3-D tensor or numpy array
    becomes a ``DenseOperator``; a callable becomes a ``FunctionOperator``
    (``example`` required for the domain structure).
    """
    if isinstance(obj, LinearOperator):
        return obj
    if isinstance(obj, (np.ndarray, torch.Tensor)) and obj.ndim in (2, 3):
        return DenseOperator(obj, example, symmetric=symmetric,
                             positive_definite=positive_definite)
    if callable(obj):
        if example is None:
            raise ValueError("as_operator(callable) needs an example of the "
                             "domain pytree")
        return FunctionOperator(obj, example, batch_ndim=batch_ndim,
                                symmetric=symmetric,
                                positive_definite=positive_definite)
    raise TypeError(f"cannot interpret {type(obj)!r} as a LinearOperator")


def jacobi_preconditioner(diag) -> Callable:
    """``M⁻¹ v = v / diag``, elementwise over a pytree of diagonals."""
    safe = tree_map(
        lambda dg: torch.where(dg.abs() > 1e-30, dg, torch.ones_like(dg)),
        diag)
    return lambda v: tree_map(lambda x, dg: x / dg, v, safe)


def jacobi_preconditioner_from(op: LinearOperator) -> Callable:
    """``M⁻¹ v = v / diag(A)`` derived from ``op.diagonal()``."""
    return jacobi_preconditioner(op.diagonal())


def block_jacobi_preconditioner(op: LinearOperator,
                                materialized=None) -> Callable:
    """Per-block dense inverse preconditioner from the operator's structure.

    For a ``BlockDiagonal`` operator this is exact (each block
    materialized and inverted); for any other operator the *leaves* of the
    domain pytree define the blocks — the matching diagonal sub-blocks of
    ``A`` are taken from one materialization and inverted, off-diagonal
    coupling dropped.  ``materialized`` skips that materialization when
    the caller already holds the dense matrix.  Returns a tree→tree
    callable usable as ``precond`` (dense small-system regime).
    """
    def instance_size(example, batched):
        if batched:
            example = tree_map(lambda l: l[0], example)
        return _ravel1(example).shape[0]

    if isinstance(op, BlockDiagonal):
        if materialized is None:
            mats = [blk.materialize() for blk in op.ops]
        else:   # slice the supplied dense matrix along the declared blocks
            mats, i = [], 0
            for blk in op.ops:
                n = instance_size(blk.example, blk.batch_ndim)
                mats.append(materialized[..., i:i + n, i:i + n])
                i += n
        inv_ops = [DenseOperator(torch.linalg.inv(m), blk.example,
                                 symmetric=blk.symmetric)
                   for m, blk in zip(mats, op.ops)]
        return lambda v: tuple(inv.matvec(vi) for inv, vi in zip(inv_ops, v))

    example = op.example
    if op.batch_ndim:
        example = tree_map(lambda l: l[0], example)
    leaves, spec = tree_flatten(example)
    A = op.materialize() if materialized is None else materialized
    invs, i = [], 0
    for leaf in leaves:
        n = int(leaf.numel())
        invs.append(torch.linalg.inv(A[..., i:i + n, i:i + n]))
        i += n

    def M(v):
        vleaves = tree_leaves(v)
        batch_shape = tuple(vleaves[0].shape[:1]) if op.batch_ndim else ()
        return tree_unflatten(
            [torch.einsum("...ij,...j->...i", inv,
                          vl.reshape(batch_shape + (-1,))).reshape(vl.shape)
             for inv, vl in zip(invs, vleaves)], spec)

    return M
