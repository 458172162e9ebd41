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

The kernel's layout rule (``kernel.layout``) at every boundary of its
lanes and values, and a float32 emulation of the kernel's bisection with
its early end (the count of values above each end of the bracket; τ in
closed form once the counts meet) against the plain 50 steps and the
sort-based oracle: random rows end early, rows whose threshold equals d - 1
of their values (a non-zero integer) run the 50 steps.

Card (``cuda`` marker; skipped without a CUDA device): the hand-written
kernel against the plain version on the same CUDA tensors, float32 and
float64 input, at shapes that take every layout of the rule (8, 16 or 32
lanes a row, 16 or 32 values a lane, and the shared-memory path for rows
longer than 1024), and rows with ties at the threshold.
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
# (d, lanes, values) at each boundary of kernel.layout's rule
LAYOUTS = [(1, 8, 16), (16, 8, 16), (17, 8, 16), (32, 8, 16), (33, 8, 16),
           (64, 8, 16), (65, 8, 16), (100, 8, 16), (128, 8, 16),
           (129, 16, 16), (256, 16, 16), (257, 32, 16), (512, 32, 16),
           (513, 32, 32), (1024, 32, 32), (1025, 32, 0), (32768, 32, 0)]
# on the card: (R, d) taking every layout, and rows with ties
CARD_SHAPES = [(4, 5), (16, 33), (64, 1000), (3, 4097), (2, 8, 12), (6, 1),
               (40, 20), (40, 101), (500, 200), (300, 300), (300, 700),
               (50000, 100)]


def _jax_op():
    import jax.numpy as jnp
    from repro.kernels.simplex_proj.ops import projection_simplex_batched
    return jnp, projection_simplex_batched


def _y(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) * 3


def _tie_rows(R, d, scale=1.0, seed=0):
    """Rows c·1 + scale·e_k, c a non-zero integer in [-3, 3]: τ = c, a value
    of d - 1 entries.  (At c = 0 the bisection's midpoint crosses τ within
    φ's rounding after two steps, and the early end comes there, rightly.)"""
    rng = np.random.default_rng(seed)
    c = rng.choice([-3.0, -2.0, -1.0, 1.0, 2.0, 3.0], (R, 1))
    y = np.repeat(c, d, axis=1)
    y[np.arange(R), rng.integers(0, d, R)] += scale
    return y


def _early_end_emulation(y, scale=1.0):
    """csrc/simplex_proj.cu's bisection in float32, row by row at once:
    φ(mid) = s − c·mid − scale from the sum s and count c of the values
    above mid; stop a row once c(lo) == c(hi) and take τ = (s(lo) − scale)
    / c(lo).  Returns (x, steps per row)."""
    yf = y.to(torch.float32)
    d = yf.shape[-1]
    hi = yf.amax(-1)
    lo = torch.minimum(hi - scale, yf.amin(-1) - scale / d)
    s_lo, c_lo = yf.sum(-1), torch.full_like(hi, float(d))
    c_hi = torch.zeros_like(hi)
    steps = torch.zeros(hi.shape, dtype=torch.int64)
    for _ in range(kernel.ITERS):
        live = c_lo != c_hi
        if not live.any():
            break
        mid = 0.5 * (lo + hi)
        above = yf > mid[..., None]
        s = torch.where(above, yf, 0.0).sum(-1)
        c = above.sum(-1).to(torch.float32)
        right = live & (s - c * mid - scale > 0)
        left = live & ~right
        lo, s_lo, c_lo = (torch.where(right, a, b) for a, b in
                          ((mid, lo), (s, s_lo), (c, c_lo)))
        hi, c_hi = torch.where(left, mid, hi), torch.where(left, c, c_hi)
        steps += live
    tau = torch.where(c_lo == c_hi, (s_lo - scale) / c_lo, 0.5 * (lo + hi))
    return torch.clamp_min(yf - tau[..., None], 0.0).to(y.dtype), steps


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


@pytest.mark.parametrize("d,lanes,values", LAYOUTS, ids=str)
def test_layout_rule(d, lanes, values):
    assert kernel.layout(d) == (lanes, values)
    if values:       # registers: the fewest lanes (at least 8) that hold it
        assert lanes * values >= d and lanes in (8, 16, 32)
        assert lanes == 8 or values == 32 or (lanes // 2) * values < d


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
@pytest.mark.parametrize("shape", [(64, 100), (32, 5), (16, 700), (4, 2000)],
                         ids=str)
def test_early_end_matches_plain_and_sort_oracle(shape, scale):
    y = torch.from_numpy(_y(shape, seed=4))
    x, steps = _early_end_emulation(y, scale)
    want = ref.projection_simplex_rows_ref(y, scale)
    limit = ATOL * max(1.0, float(y.abs().max()))
    assert float((x - want).abs().max()) <= limit
    assert float((x - projection_simplex(y, scale)).abs().max()) <= limit
    assert int(steps.max()) < kernel.ITERS      # every row ended early


@pytest.mark.parametrize("shape", [(64, 100), (8, 2000), (6, 3)], ids=str)
def test_ties_at_the_threshold_run_every_step(shape):
    y = torch.from_numpy(_tie_rows(*shape, seed=5))
    x, steps = _early_end_emulation(y)
    want = ref.projection_simplex_rows_ref(y)
    limit = ATOL * max(1.0, float(y.abs().max()))
    assert bool((steps == kernel.ITERS).all())  # the early end never came
    assert float((x - want).abs().max()) <= limit
    assert float((x - projection_simplex(y)).abs().max()) <= limit


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
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(64, 100), (8, 2000), (6, 3)], ids=str)
def test_kernel_with_ties_at_the_threshold_on_card(cuda_device, shape,
                                                   dtype):
    y = torch.from_numpy(_tie_rows(*shape, seed=6)).to(cuda_device, dtype)
    x = ops.projection_simplex_batched(y, 1.0)
    torch.cuda.synchronize()
    want = ref.projection_simplex_rows_ref(y, 1.0)
    assert x.dtype == dtype
    assert float((x - want).abs().max()) <= ATOL * float(y.abs().max())
    assert float((x.sum(-1) - 1.0).abs().max()) <= 1e-4
