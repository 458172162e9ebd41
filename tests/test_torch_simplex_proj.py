"""The port's simplex-projection op against the JAX op, and its kernel.

CPU: the port's plain version (``ref.py``, what the op runs on CPU
tensors) against the JAX op ``projection_simplex_batched(Y, scale, True)``
— the Pallas kernel body in interpret mode, as ``tests/test_kernels.py``
runs it — and against the sort-based oracle
``repro_torch.core.projections.projection_simplex``, at shapes (8, 16),
(16, 33), (32, 128), (4, 5) and (2, 8, 12) and scale 0.5, 1 and 3.
Tolerance 1e-5 absolute: both versions bisect in float32 (the same 50
steps over the same bracket; only the order of the φ-sums differs).
Jacobians by ``torch.func.jacfwd`` / ``jacrev`` against ``jax.jacfwd`` at
a point away from the support's kinks, within 1e-9 (closed-form Jacobians
of the same support); ``torch.func.vmap`` of the op against the folded
call.

Card (``cuda`` marker; skipped without a CUDA device): the hand-written
kernel against the plain version on the same CUDA tensors, float32 and
float64 input, including a row longer than 1024 (the shared-memory path).
The JAX package is imported inside the tests that use it, so that on a
machine without JAX the card tests run alone::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_simplex_proj.py
"""
import numpy as np
import pytest
import torch
import torch.func

from repro_torch.core.projections import projection_simplex
from repro_torch.kernels.simplex_proj import kernel, ops, ref

ATOL = 1e-5
SHAPES = [(8, 16), (16, 33), (32, 128), (4, 5), (2, 8, 12)]


def _jax_op():
    import jax.numpy as jnp
    from repro.kernels.simplex_proj.ops import projection_simplex_batched
    return jnp, projection_simplex_batched


def _y(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) * 3


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_jax_op_and_sort_oracle(shape, scale):
    jnp, jax_op = _jax_op()
    y = _y(shape).astype(np.float32)
    x = ops.projection_simplex_batched(torch.from_numpy(y), scale)
    assert x.dtype == torch.float32 and x.shape == y.shape
    x_pallas = np.asarray(jax_op(jnp.asarray(y), scale, True))
    x_sort = projection_simplex(torch.from_numpy(y).double(), scale)
    np.testing.assert_allclose(x.numpy(), x_pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(x.numpy(), x_sort.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(x.numpy().sum(-1), scale, atol=ATOL)
    assert (x >= 0).all()


def test_float64_input_is_computed_in_float32():
    y = torch.from_numpy(_y((6, 9)))
    x = ops.projection_simplex_batched(y)
    assert x.dtype == torch.float64
    assert torch.equal(x, ref.projection_simplex_rows_ref(y.float())
                       .double())


def test_jacobians_match_jax_jacfwd():
    import jax
    jnp, jax_op = _jax_op()
    y = np.array([[0.3, -0.1, 0.8, 0.07], [1.2, 0.9, -0.4, 0.1]])

    def op_t(v):
        return ops.projection_simplex_batched(v)

    jac_fwd = torch.func.jacfwd(op_t)(torch.from_numpy(y))
    jac_rev = torch.func.jacrev(op_t)(torch.from_numpy(y))
    want = np.asarray(jax.jacfwd(lambda v: jax_op(v, 1.0, True))(
        jnp.asarray(y)))
    np.testing.assert_allclose(jac_fwd.numpy(), want, atol=1e-9, rtol=0)
    np.testing.assert_allclose(jac_rev.numpy(), want, atol=1e-9, rtol=0)


def test_backward_and_vmap():
    y = torch.from_numpy(_y((3, 5, 7), seed=1))
    folded = ops.projection_simplex_batched(y)
    for dim in (0, 1):
        mapped = torch.func.vmap(ops.projection_simplex_batched,
                                 in_dims=dim, out_dims=dim)(y)
        assert torch.equal(mapped, folded)
    t = torch.from_numpy(_y((3, 5, 7), seed=2))
    jvp_mapped = torch.func.vmap(lambda a, b: torch.func.jvp(
        ops.projection_simplex_batched, (a,), (b,))[1])(y, t)
    _, jvp_folded = torch.func.jvp(ops.projection_simplex_batched, (y,), (t,))
    assert torch.equal(jvp_mapped, jvp_folded)
    yg = y.clone().requires_grad_()
    (g,) = torch.autograd.grad((ops.projection_simplex_batched(yg) * t).sum(),
                               yg)
    torch.testing.assert_close(g, jvp_folded, rtol=0, atol=1e-15)


def test_cpu_path_never_launches_and_device_rule():
    y = torch.from_numpy(_y((4, 6)))
    before = ops.LAUNCHES
    ops.projection_simplex_batched(y)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(y)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with `pytest -m cuda` on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(4, 5), (16, 33), (64, 1000), (3, 4097),
                                   (2, 8, 12)], ids=str)
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    y = torch.from_numpy(_y(shape, seed=3)).to(cuda_device, dtype)
    before = ops.LAUNCHES
    x = ops.projection_simplex_batched(y, 1.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = ref.projection_simplex_rows_ref(y, 1.0)
    assert x.dtype == dtype
    scale = max(1.0, float(y.abs().max()))
    assert float((x - want).abs().max()) <= ATOL * scale
    assert float((x.sum(-1) - 1.0).abs().max()) <= 1e-4
