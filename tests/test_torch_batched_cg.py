"""The port's batched-CG op against the JAX op, and its kernels on the card.

CPU: the port's plain version (``ref.py``, what the op runs on CPU
tensors) against the JAX op ``batched_cg(..., interpret=True)`` — the
Pallas kernel body in interpret mode, as ``tests/test_batched_solve.py``
runs it — and against ``batched_cg_ref``, for d ∈ {7, 96, 130},
B ∈ {1, 3, 8}, float64 and float32; gradients in A and b against
``jax.grad`` through the JAX op.  Tolerance ‖Δx‖/‖x‖ ≤ 1e-10 in float64
and 1e-4 in float32 (the two float32 runs sum in different orders).
The layout rule ``kernel.layout`` (cluster sizes 1, 2, 4, 8 or the stream
route) against the shapes it must give, and a slice-by-slice CPU
emulation of the cluster kernel (``csrc/batched_cg_cluster.cu``: each
CTA's rows of A, or columns for the transposed solve, and the CTAs'
partial sums added in rank order) against ``batched_cg_ref`` and the JAX
op, both directions, to the same tolerances.

Card (``cuda`` marker; skipped without a CUDA device): the hand-written
kernels against the plain version on the same CUDA tensors, forward and
backward, at shapes that take every layout, each layout also asked for
by name, and the cluster route on batches of mixed conditioning, of
several waves, with zero right-hand sides, with an iteration cap that is
hit and of one instance; each case's layout read from
``ops.LAUNCHES_BY_LAYOUT``.  The JAX package is imported inside the tests
that use it, so that on a machine without JAX the card tests run alone::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_batched_cg.py
"""
import ctypes
import importlib.util
from pathlib import Path

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


def _nonsymmetric(B, d, dtype, seed=0):
    """A = M + K, M SPD (``_problem``) and K skew-symmetric: pᵀAp = pᵀMp > 0,
    so CG's steps are defined, and Aᵀ ≠ A, so a solve on Aᵀ shows which of
    rows and columns a slice took."""
    A, b = _problem(B, d, np.float64, seed)
    rng = np.random.default_rng(seed + 100)
    N = rng.standard_normal((B, d, d)) / np.sqrt(d)
    return (A + 0.3 * (N - N.transpose(0, 2, 1))).astype(dtype), b.astype(
        dtype)


def cluster_cg_emulation(A, b, *, tol, maxiter, clusters, transpose=False):
    """The cluster kernel's arithmetic on the CPU, slice by slice.

    Instance by instance, as one cluster of ``clusters`` CTAs: CTA c holds
    rows [cR, (c+1)R) of A (R = ⌈d/C⌉), or for ``transpose`` columns
    [cR, (c+1)R) of A as its rows; it computes its slice of Ap and its
    partials of pᵀAp and rᵀr; the partials are added in rank order 0 … C−1
    as every CTA adds them; p = r + βp is formed over the whole vector from
    the CTAs' r slices, skipped when the loop ends.  Computes in
    promote(dtype, float32) and returns b's dtype.
    """
    dtype = torch.promote_types(torch.promote_types(A.dtype, b.dtype),
                                torch.float32)
    out_dtype = b.dtype
    A, b = A.to(dtype), b.to(dtype)
    B, d = b.shape
    R = -(-d // clusters)
    bounds = [(min(c * R, d), min((c + 1) * R, d)) for c in range(clusters)]
    slices = [A[:, :, lo:hi].transpose(1, 2) if transpose else A[:, lo:hi, :]
              for lo, hi in bounds]
    tol2 = torch.tensor(tol * tol, dtype=dtype)
    zero = torch.zeros((), dtype=dtype)

    def in_rank_order(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    x = torch.zeros_like(b)
    for n in range(B):
        p = b[n].clone()
        r = [b[n, lo:hi].clone() for lo, hi in bounds]
        xs = [torch.zeros(hi - lo, dtype=dtype) for lo, hi in bounds]
        bb = torch.dot(b[n], b[n])
        rs = bb
        atol2 = torch.clamp_min(tol2 * bb, 1e-30)
        k = 0
        while k < maxiter and bool(rs > atol2):
            ap = [S[n] @ p for S in slices]
            denom = in_rank_order([torch.dot(p[lo:hi], a)
                                   for (lo, hi), a in zip(bounds, ap)])
            alpha = zero if denom == 0 else rs / denom
            for c, (lo, hi) in enumerate(bounds):
                xs[c] = xs[c] + alpha * p[lo:hi]
                r[c] = r[c] - alpha * ap[c]
            rs_new = in_rank_order([torch.dot(rc, rc) for rc in r])
            beta = zero if rs == 0 else rs_new / rs
            rs = rs_new
            if k + 1 < maxiter and bool(rs > atol2):
                p = torch.cat(r) + beta * p
            k += 1
        x[n] = torch.cat(xs)
    return x.to(out_dtype)


def _chip_smoke():
    """``chip_smoke.py`` at the root of the checkout, as a module."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


# -- the layout rule and the cluster kernel's arithmetic ---------------------

LAYOUT_WANT = [
    (torch.float32, 7, "C1"), (torch.float32, 96, "C1"),
    (torch.float32, 130, "C1"), (torch.float32, 300, "C2"),
    (torch.float32, 400, "C4"), (torch.float32, 512, "C8"),
    (torch.float64, 130, "C1"), (torch.float64, 300, "C4"),
    (torch.float64, 400, "C8"), (torch.float64, 512, "stream")]


@pytest.mark.parametrize("dtype,d,want", LAYOUT_WANT,
                         ids=[f"{str(t)[6:]}-{d}" for t, d, _ in LAYOUT_WANT])
def test_layout_rule(dtype, d, want):
    assert kernel.layout(d, dtype) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_layout_is_the_smallest_cluster_that_fits(dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
    for d in range(1, kernel.MAX_DIM + 1):
        name = kernel.layout(d, dtype)
        fit = [c for c in (1, 2, 4, 8)
               if kernel.smem_bytes(d, itemsize, c) <= kernel.SMEM_BUDGET]
        assert name == (f"C{fit[0]}" if fit else "stream"), d
        if name != "stream":
            assert kernel._check_layout(name, d, dtype) == int(name[1:])
        for c in (1, 2, 4, 8):
            if c not in fit:
                with pytest.raises(ValueError, match="shared memory"):
                    kernel._check_layout(f"C{c}", d, dtype)
    with pytest.raises(ValueError, match="layouts"):
        kernel._check_layout("C16", 7, dtype)


def test_phase3_shapes_take_every_layout():
    smoke = _chip_smoke()
    taken = {kernel.layout(d, dtype) for _, d in smoke.CG_SHAPES
             for dtype in (torch.float32, torch.float64)}
    assert taken == set(kernel.LAYOUTS)
    assert set(ops.LAUNCHES_BY_LAYOUT) == set(kernel.LAYOUTS)


def test_cpu_path_counts_no_layout():
    A, b = _problem(2, 5, np.float64)
    before = dict(ops.LAUNCHES_BY_LAYOUT)
    ops.batched_cg(torch.from_numpy(A), torch.from_numpy(b), device="cpu")
    assert ops.LAUNCHES_BY_LAYOUT == before


@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("clusters", [1, 2, 4, 8])
@pytest.mark.parametrize("B,d", [(3, 7), (2, 130)])
def test_cluster_emulation_matches_ref_and_jax_op(B, d, clusters, dtype,
                                                  transpose):
    jax, jnp, jax_batched_cg, _ = _jax()
    A, b = _problem(B, d, dtype, seed=3)
    tol = SOLVE_TOL[dtype]
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x = cluster_cg_emulation(At, bt, tol=tol, maxiter=d,
                             clusters=clusters, transpose=transpose)
    want = ref.batched_cg_ref(At.transpose(1, 2) if transpose else At, bt,
                              tol=tol, maxiter=d)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    if transpose:    # the JAX op's backward: u = A⁻ᵀ g, the solve on Aᵀ
        _, vjp = jax.vjp(lambda b_: jax_batched_cg(Aj, b_, tol=tol), bj)
        (x_jax,) = vjp(bj)
    else:
        x_jax = jax_batched_cg(Aj, bj, tol=tol)
    assert x.dtype == TORCH[dtype]
    assert _rel(x, want) <= RTOL[dtype]
    assert _rel(x, x_jax) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("clusters", [1, 2, 4, 8])
def test_cluster_emulation_transposed_slices_are_columns(clusters, dtype):
    """On a non-symmetric A (six steps, no stopping test) the transposed
    emulation, whose slices are columns of A, is the solve on Aᵀ and not
    the one on A."""
    _, jnp, jax_batched_cg, _ = _jax()
    A, b = _nonsymmetric(3, 37, dtype, seed=4)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    u = cluster_cg_emulation(At, bt, tol=0.0, maxiter=6, clusters=clusters,
                             transpose=True)
    want = ref.batched_cg_ref(At.transpose(1, 2), bt, tol=0.0, maxiter=6)
    u_jax = jax_batched_cg(jnp.asarray(A).transpose(0, 2, 1),
                           jnp.asarray(b), tol=0.0, maxiter=6)
    other = ref.batched_cg_ref(At, bt, tol=0.0, maxiter=6)
    assert _rel(u, want) <= RTOL[dtype]
    assert _rel(u, u_jax) <= RTOL[dtype]
    assert _rel(u, other) > 1e-2


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with `pytest -m cuda` on the "
                    "card)")
    return torch.device("cuda")


def _plain_grads(A, b, tol, maxiter):
    """x, ∂b and ∂A of Σx² by the plain version."""
    x_ref = ref.batched_cg_ref(A, b, tol=tol, maxiter=maxiter)
    u_ref = ref.batched_cg_ref(A.transpose(1, 2), 2 * x_ref, tol=tol,
                               maxiter=maxiter)
    return x_ref, u_ref, -u_ref[:, :, None] * x_ref[:, None, :]


def _op_with_grads(A, b, tol, maxiter):
    """x, ∂b and ∂A of Σx² through the op, and the layouts it launched."""
    At, bt = A.clone().requires_grad_(), b.clone().requires_grad_()
    before = dict(ops.LAUNCHES_BY_LAYOUT)
    x = ops.batched_cg(At, bt, tol=tol, maxiter=maxiter)
    gA, gb = torch.autograd.grad((x ** 2).sum(), (At, bt))
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ops.LAUNCHES_BY_LAYOUT.items()
                if v != before[k]}
    return x.detach(), gb, gA, launched


def _cuda_problem(B, d, dtype, device, seed=2):
    A, b = _problem(B, d, dtype, seed=seed)
    return torch.from_numpy(A).to(device), torch.from_numpy(b).to(device)


# (B, d): with both dtypes they take every layout (see LAYOUT_WANT)
CARD_SHAPES = [(1, 7), (3, 96), (8, 130), (16, 300), (8, 400), (64, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,d", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, B, d, dtype):
    A, b = _cuda_problem(B, d, dtype, cuda_device)
    tol = SOLVE_TOL[dtype]
    before = ops.LAUNCHES
    x, gb, gA, launched = _op_with_grads(A, b, tol, 4 * d)
    assert ops.LAUNCHES == before + 2              # forward + backward
    assert launched == {kernel.layout(d, TORCH[dtype]): 2}
    x_ref, u_ref, gA_ref = _plain_grads(A, b, tol, 4 * d)
    assert _rel(x.cpu(), x_ref.cpu()) <= RTOL[dtype]
    assert _rel(gb.cpu(), u_ref.cpu()) <= RTOL[dtype]
    assert _rel(gA.cpu(), gA_ref.cpu()) <= RTOL[dtype]


EVERY_LAYOUT = [(name, dtype, d) for name in kernel.LAYOUTS
                for dtype in (np.float64, np.float32) for d in (96, 300)
                if name == "stream" or kernel.smem_bytes(
                    d, np.dtype(dtype).itemsize, int(name[1:]))
                <= kernel.SMEM_BUDGET]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,dtype,d", EVERY_LAYOUT,
    ids=[f"{n}-{np.dtype(t).name}-{d}" for n, t, d in EVERY_LAYOUT])
def test_every_layout_matches_plain_on_card(cuda_device, name, dtype, d):
    """Each layout asked for by name: the SPD solve in both directions, and
    six steps on a non-symmetric A transposed (columns, not rows)."""
    A, b = _cuda_problem(5, d, dtype, cuda_device, seed=5)
    tol = SOLVE_TOL[dtype]
    want = ref.batched_cg_ref(A, b, tol=tol, maxiter=4 * d)
    for transpose in (False, True):
        x = kernel.launch(A, b, tol=tol, maxiter=4 * d, transpose=transpose,
                          layout=name)
        torch.cuda.synchronize()
        assert _rel(x.cpu(), want.cpu()) <= RTOL[dtype]
    An, bn = _nonsymmetric(5, d, dtype, seed=6)
    An = torch.from_numpy(An).to(cuda_device)
    bn = torch.from_numpy(bn).to(cuda_device)
    u = kernel.launch(An, bn, tol=0.0, maxiter=6, transpose=True,
                      layout=name)
    torch.cuda.synchronize()
    want = ref.batched_cg_ref(An.transpose(1, 2), bn, tol=0.0, maxiter=6)
    assert _rel(u.cpu(), want.cpu()) <= RTOL[dtype]


@pytest.mark.cuda
def test_smem_bytes_match_the_cuda_source(cuda_device):
    """The layout rule's byte count is the one the C functions refuse by."""
    fn = kernel._function("batched_cg_cluster_smem_bytes", [ctypes.c_int] * 3)
    fn.restype = ctypes.c_longlong
    for itemsize in (4, 8):
        for d in range(1, kernel.MAX_DIM + 1):
            for c in (1, 2, 4, 8):
                assert fn(itemsize, d, c) == kernel.smem_bytes(d, itemsize,
                                                               c)


@pytest.mark.cuda
def test_layout_that_does_not_fit_raises_on_card(cuda_device):
    A, b = _cuda_problem(2, 300, np.float64, cuda_device)
    for name in ("C1", "C2"):
        with pytest.raises(ValueError, match="shared memory"):
            kernel.launch(A, b, tol=1e-8, maxiter=10, layout=name)
    fn = kernel._function(kernel._CLUSTER_FUNCS[torch.float64],
                          kernel._ARGTYPES + [ctypes.c_int, ctypes.c_void_p])
    x = torch.empty_like(b)
    stream = torch.cuda.current_stream().cuda_stream
    for c in (1, 2, 3, 16):     # over the budget, or not a portable size
        assert fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), 2, 300, 1e-8, 10,
                  0, c, stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(np.float32, 512), (np.float64, 400)],
                         ids=["f32-512", "f64-400"])
def test_mixed_conditioning_on_card(cuda_device, dtype, d):
    """Ridge systems XᵀX/d + θI, X (d, d), θ log-uniform over [1e-4, 1]:
    condition numbers from ≈ 4 to ≈ 4e4, so the clusters of a wave leave
    their loops on different iterations.  The batch equals each instance
    solved alone bit for bit; each x is within 2κ·tol + κ·RTOL of the plain
    version's (both stop at ‖r‖ ≤ tol‖b‖, so they differ by at most
    2κ·tol; κ·RTOL for rounding)."""
    rng = np.random.default_rng(7)
    B, tol = 48, {np.float32: 1e-5, np.float64: 1e-10}[dtype]
    X = rng.standard_normal((B, d, d))
    theta = np.exp(rng.uniform(np.log(1e-4), 0.0, B))
    A = np.einsum("bki,bkj->bij", X, X) / d + theta[:, None, None] * np.eye(d)
    b = rng.standard_normal((B, d))
    kappa = np.array([np.linalg.cond(a) for a in A])
    At = torch.from_numpy(A.astype(dtype)).to(cuda_device)
    bt = torch.from_numpy(b.astype(dtype)).to(cuda_device)
    before = dict(ops.LAUNCHES_BY_LAYOUT)
    x = ops.batched_cg(At, bt, tol=tol, maxiter=4 * d)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_LAYOUT["C8"] == before["C8"] + 1
    for n in (0, 1, B // 2, B - 1):
        alone = ops.batched_cg(At[n:n + 1], bt[n:n + 1], tol=tol,
                               maxiter=4 * d)
        assert torch.equal(alone[0], x[n])
    from repro_torch.core import DenseOperator, linear_solve
    x_ref, info = linear_solve.solve_cg(
        DenseOperator(At, positive_definite=True), bt, tol=tol,
        maxiter=4 * d, batch_ndim=1, return_info=True)
    iters = info.iterations.cpu().numpy()
    assert iters.max() - iters.min() >= 10, iters
    x_ref = ref.batched_cg_ref(At, bt, tol=tol, maxiter=4 * d)
    err = (torch.linalg.vector_norm((x - x_ref).double(), dim=-1)
           / torch.linalg.vector_norm(x_ref.double(), dim=-1)).cpu().numpy()
    assert np.all(err <= 2 * kappa * tol + kappa * RTOL[dtype]), err


CLUSTER_CASES = ["waves", "zero_rhs", "maxiter_cap", "single"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(np.float32, 512), (np.float64, 400)],
                         ids=["f32-512", "f64-400"])
@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_cluster_cases_on_card(cuda_device, case, dtype, d):
    """The C8 route, forward and backward, against the plain version: 200
    instances (several waves of clusters), rows with b = 0 (x = 0 exactly),
    an iteration cap of 3 that every instance hits, and one instance."""
    B = {"waves": 200, "zero_rhs": 8, "maxiter_cap": 16, "single": 1}[case]
    maxiter = 3 if case == "maxiter_cap" else 4 * d
    A, b = _cuda_problem(B, d, dtype, cuda_device, seed=8)
    if case == "zero_rhs":
        b[0] = 0
        b[3] = 0
    tol = SOLVE_TOL[dtype]
    x, gb, gA, launched = _op_with_grads(A, b, tol, maxiter)
    assert launched == {"C8": 2}
    x_ref, u_ref, gA_ref = _plain_grads(A, b, tol, maxiter)
    if case == "zero_rhs":
        assert torch.count_nonzero(x[[0, 3]]) == 0
        assert torch.count_nonzero(gb[[0, 3]]) == 0
    assert _rel(x.cpu(), x_ref.cpu()) <= RTOL[dtype]
    assert _rel(gb.cpu(), u_ref.cpu()) <= RTOL[dtype]
    assert _rel(gA.cpu(), gA_ref.cpu()) <= RTOL[dtype]


@pytest.mark.cuda
def test_vjp_mode_second_derivative_launches_the_kernel_on_card(
        cuda_device):
    """``grad(grad)`` of Σx*² through a ``mode="vjp"`` wrapper routed to
    ``pallas_cg``, whose reverse rule solves the flipped system again:
    three launches (the inner cotangent solve, x*'s outer one, the flipped
    solve) for 8 ridge problems at d = 96 under ``vmap``, equal to the
    plain path's value (the same wrapper on CPU tensors)."""
    from repro_torch.core.diff_api import implicit_diff
    rng = np.random.default_rng(9)
    B, d, m = 8, 96, 192
    X, y = rng.standard_normal((B, m, d)), rng.standard_normal((B, m))
    theta = np.linspace(0.1, 1.0, B)

    def second(device):
        eye = torch.eye(d, dtype=torch.float64, device=device)

        def F(x, X, y, t):
            return X.T @ (X @ x - y) / m + t * x

        ridge = implicit_diff(F, solve="pallas_cg", tol=1e-12, mode="vjp")(
            lambda init, X, y, t: torch.linalg.solve(
                X.T @ X / m + t * eye, X.T @ y / m))
        loss = lambda X, y, t: (ridge(None, X, y, t) ** 2).sum()  # noqa: E731
        fn = torch.func.grad(torch.func.grad(loss, argnums=2), argnums=2)
        return torch.func.vmap(fn)(*(torch.from_numpy(a).to(device)
                                     for a in (X, y, theta)))

    before = dict(ops.LAUNCHES_BY_LAYOUT)
    got = second(cuda_device)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ops.LAUNCHES_BY_LAYOUT.items()
                if v != before[k]}
    assert sum(launched.values()) == 3, launched
    want = second(torch.device("cpu"))
    assert _rel(got.cpu(), want) <= 1e-8
