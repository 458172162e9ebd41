"""The port's batched-CG op against the JAX op, and its kernel on the card.

CPU: the port's plain version (``ref.py``, what the op runs on CPU
tensors) against the JAX op ``batched_cg(..., interpret=True)`` — the
Pallas kernel body in interpret mode, as ``tests/test_batched_solve.py``
runs it — and against ``batched_cg_ref``, for d ∈ {7, 96, 130},
B ∈ {1, 3, 8}, float64 and float32; gradients in A and b against
``jax.grad`` through the JAX op.  Tolerance ‖Δx‖/‖x‖ ≤ 1e-10 in float64
and 1e-4 in float32 (the two float32 runs sum in different orders).

Card (``cuda`` marker; skipped without a CUDA device): the hand-written
kernel against the plain version on the same CUDA tensors, forward and
backward, at the same shapes plus (64, 512).  The JAX package is imported
inside the tests that use it, so that on a machine without JAX the card
tests run alone::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_batched_cg.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import operators as tops
from repro_torch.kernels.batched_cg import kernel, ops, ref

RTOL = {np.float64: 1e-10, np.float32: 1e-4}
SOLVE_TOL = {np.float64: 1e-12, np.float32: 1e-6}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}


def _problem(B, d, dtype, seed=0):
    """Ridge-type SPD systems A = XᵀX/(2d) + 0.1 I (condition ≈ 16)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, 2 * d, d))
    A = np.einsum("bki,bkj->bij", X, X) / (2 * d) + 0.1 * np.eye(d)
    b = rng.standard_normal((B, d))
    return A.astype(dtype), b.astype(dtype)


def _jax():
    """``jax``, ``jax.numpy`` and the JAX op and reference."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.batched_cg.ops import batched_cg
    from repro.kernels.batched_cg.ref import batched_cg_ref
    return jax, jnp, batched_cg, batched_cg_ref


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("d", [7, 96, 130])
def test_ref_matches_jax_op_and_ref(d, B, dtype):
    _, jnp, jax_batched_cg, jax_cg_ref = _jax()
    A, b = _problem(B, d, dtype)
    tol = SOLVE_TOL[dtype]
    x_t = ref.batched_cg_ref(torch.from_numpy(A), torch.from_numpy(b),
                             tol=tol, maxiter=d)
    x_op = ops.batched_cg(torch.from_numpy(A), torch.from_numpy(b), tol=tol,
                          device="cpu")
    x_pallas = jax_batched_cg(jnp.asarray(A), jnp.asarray(b), tol=tol,
                              interpret=True)
    x_jref = jax_cg_ref(jnp.asarray(A), jnp.asarray(b), tol=tol, maxiter=d)
    assert x_t.dtype == TORCH[dtype] and x_op.dtype == TORCH[dtype]
    assert _rel(x_t, x_pallas) <= RTOL[dtype]
    assert _rel(x_t, x_jref) <= RTOL[dtype]
    assert _rel(x_op, x_t) == 0.0


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,d", [(3, 7), (2, 96)])
def test_gradients_match_jax(B, d, dtype):
    jax, jnp, jax_batched_cg, _ = _jax()
    A, b = _problem(B, d, dtype, seed=1)
    tol = SOLVE_TOL[dtype]
    gA_j, gb_j = jax.grad(
        lambda A_, b_: jnp.sum(jax_batched_cg(A_, b_, tol=tol,
                                              interpret=True) ** 2),
        argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))
    At = torch.from_numpy(A).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    x = ops.batched_cg(At, bt, tol=tol, device="cpu")
    gA_t, gb_t = torch.autograd.grad((x ** 2).sum(), (At, bt))
    assert _rel(gA_t, gA_j) <= RTOL[dtype]
    assert _rel(gb_t, gb_j) <= RTOL[dtype]


def test_cpu_path_never_launches_and_device_rule():
    A, b = _problem(2, 5, np.float64)
    before = ops.LAUNCHES
    ops.batched_cg(torch.from_numpy(A), torch.from_numpy(b), device="cpu")
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(torch.from_numpy(A), torch.from_numpy(b), tol=1e-6,
                      maxiter=5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.batched_cg(torch.from_numpy(A), torch.from_numpy(b))


def test_operator_input_and_symmetry_refusal():
    A, b = _problem(3, 6, np.float64)
    op = tops.DenseOperator(torch.from_numpy(A), positive_definite=True)
    x = ops.batched_cg(op, torch.from_numpy(b), tol=1e-12, device="cpu")
    want = np.linalg.solve(A, b[..., None])[..., 0]
    assert _rel(x, want) <= 1e-10
    with pytest.raises(ValueError, match="SPD"):
        ops.batched_cg(tops.DenseOperator(torch.from_numpy(A),
                                          symmetric=False),
                       torch.from_numpy(b), device="cpu")


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with `pytest -m cuda` on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,d", [(1, 7), (3, 96), (8, 130), (64, 512)])
def test_kernel_matches_plain_on_card(cuda_device, B, d, dtype):
    A, b = _problem(B, d, dtype, seed=2)
    tol = SOLVE_TOL[dtype]
    At = torch.from_numpy(A).to(cuda_device).requires_grad_()
    bt = torch.from_numpy(b).to(cuda_device).requires_grad_()
    before = ops.LAUNCHES
    x = ops.batched_cg(At, bt, tol=tol, maxiter=4 * d)
    gA, gb = torch.autograd.grad((x ** 2).sum(), (At, bt))
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 2              # forward + backward
    A0, b0 = At.detach(), bt.detach()
    x_ref = ref.batched_cg_ref(A0, b0, tol=tol, maxiter=4 * d)
    u_ref = ref.batched_cg_ref(A0.transpose(1, 2), 2 * x_ref, tol=tol,
                               maxiter=4 * d)
    gA_ref = -u_ref[:, :, None] * x_ref[:, None, :]
    assert _rel(x.detach().cpu(), x_ref.cpu()) <= RTOL[dtype]
    assert _rel(gb.cpu(), u_ref.cpu()) <= RTOL[dtype]
    assert _rel(gA.cpu(), gA_ref.cpu()) <= RTOL[dtype]
