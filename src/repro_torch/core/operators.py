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
  * ``RidgeShifted`` — ``A + λI`` damping that preserves structure.
  * ``FunctionOperator`` / ``TransposedOperator`` / ``as_operator`` and
    the Jacobi preconditioners.

Defaults are matrix-free: ``rmatvec`` is the VJP of ``matvec`` (the
transpose of a linear map), or ``matvec`` itself under declared symmetry;
``diagonal()`` / ``materialize()`` probe with basis vectors through
``torch.func.vmap`` (``d`` matvecs in one batched call).  Structured
operators answer in O(1).

Pytrees are ``torch.utils._pytree`` trees whose dicts flatten in sorted
key order, as in JAX (see ``repro_torch.core._tree``), so raveled vectors
and materialized matrices line up with the JAX package's.

``SampledJacobianOperator``, ``BlockDiagonal``, ``ComposedOperator``,
``RaveledOperator`` and ``block_jacobi_preconditioner`` are not ported
yet (ROADMAP queue A.2).  This module imports nothing else of the package.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.func

from repro_torch.core._tree import (canonical, ravel_batched, ravel_pytree,
                                    tree_map)


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
