"""The port's roofline model and operation census against the JAX package.

Roofline: ``analyze_solve``'s counts (``hlo_flops``, ``hlo_bytes``,
``model_flops``, ``useful_ratio``, ``chips``) equal the reference's over a
grid of (B, d, mesh_size, instance_sharded, dtype size); its seconds are
those counts over the port's H100 constants (the compute term at the CUDA
cores' rate of the solve's type).  ``analyze`` likewise, and the model
FLOP formulas are the reference's.

Census: a loop of 40 matrix products (``lax.fori_loop`` and ``lax.scan``
on the JAX side, a Python loop on the port's) and a convolution have the
FLOPs that ``repro.analysis.hlo.analyze_module`` reads off XLA's compiled
HLO.  Bytes are held to the port's own rule — every eager aten
operation's operands and outputs, views and allocations nothing, a
broadcast axis once — not to XLA's fusion boundaries.  A kernel launch is
recorded as a custom call in every active census and nowhere else; the
collectives of ``c10d`` are counted by kind on a one-process ``gloo``
group.  Card (``cuda`` marker): the flash-attention and batched-CG ops
under a census record their launches.
"""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.analysis import op_census, roofline

F64 = torch.float64


def _jax():
    jax = importlib.import_module("jax")
    return jax, importlib.import_module("jax.numpy")


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

COUNTS = ("hlo_flops", "hlo_bytes", "model_flops", "useful_ratio", "chips",
          "collective_bytes", "collective_s")


@pytest.mark.parametrize("dtype_bytes", [4, 8])
@pytest.mark.parametrize("instance_sharded", [False, True])
@pytest.mark.parametrize("mesh_size", [1, 2, 8])
@pytest.mark.parametrize("B,d", [(1, 7), (64, 16), (64, 512), (4, 600)])
def test_analyze_solve_counts_equal_reference(B, d, mesh_size,
                                              instance_sharded, dtype_bytes):
    from repro.analysis import roofline as jroof
    kw = dict(dtype_bytes=dtype_bytes, mesh_size=mesh_size,
              instance_sharded=instance_sharded)
    got = roofline.analyze_solve(B, d, **kw)
    want = jroof.analyze_solve(B, d, **kw)
    for field in COUNTS:
        assert getattr(got, field) == pytest.approx(getattr(want, field),
                                                    rel=1e-15), field
    peak = {4: 67e12, 8: 34e12}[dtype_bytes]
    assert got.compute_s == pytest.approx(got.hlo_flops / peak)
    assert got.memory_s == pytest.approx(got.hlo_bytes / 3.35e12)
    iters = roofline.expected_solve_iters(d)
    assert got.solve_iteration_s == pytest.approx(got.step_time_s / iters)
    assert roofline.analyze_solve(B, d, iters=3, **kw).hlo_flops == \
        pytest.approx(jroof.analyze_solve(B, d, iters=3, **kw).hlo_flops)


def test_constants_and_formulas():
    from repro.analysis import roofline as jroof
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == \
        (989e12, 3.35e12, 450e9)
    assert roofline.PSUM_LATENCY_S == jroof.PSUM_LATENCY_S
    for d in range(1, 700, 7):
        assert roofline.expected_solve_iters(d) == \
            jroof.expected_solve_iters(d)
    assert roofline.model_flops_train(1e9, 1e6) == \
        jroof.model_flops_train(1e9, 1e6) == 6e15
    assert roofline.model_flops_decode(1e9, 128) == \
        jroof.model_flops_decode(1e9, 128)


def test_analyze_terms_and_dominant():
    from repro.analysis import roofline as jroof
    cost = {"flops": 989e12, "bytes accessed": 3.35e12 * 2}
    t = roofline.analyze(cost, coll_bytes=450e9 * 3, chips=4,
                         model_flops=989e12 * 4 * 0.5)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(2.0)
    assert t.collective_s == pytest.approx(3.0)
    assert t.dominant == "collective" and t.step_time_s == pytest.approx(3.0)
    assert t.mfu == pytest.approx(0.5 / 3.0)
    want = jroof.analyze(cost, coll_bytes=450e9 * 3, chips=4,
                         model_flops=989e12 * 4 * 0.5)
    for field in ("hlo_flops", "hlo_bytes", "useful_ratio", "chips"):
        assert getattr(t, field) == getattr(want, field)
    assert set(t.to_dict()) == set(want.to_dict())
    assert roofline.analyze({}, 0.0, 1, 0.0).mfu == 0.0


# ---------------------------------------------------------------------------
# the census against hlo.analyze_module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loop", ["fori_loop", "scan"])
def test_loop_of_products_equals_hlo(loop):
    jax, jnp = _jax()
    from repro.analysis import hlo
    L, d = 40, 32
    w_np = np.random.default_rng(0).standard_normal((L, d, d)) / d
    x_np = np.random.default_rng(1).standard_normal((4, d))
    if loop == "fori_loop":
        def jf(w, x):
            return jax.lax.fori_loop(0, L, lambda i, h: h @ w[i], x)
    else:
        def jf(w, x):
            return jax.lax.scan(lambda h, wl: (h @ wl, None), x, w)[0]
    text = jax.jit(jf).lower(jnp.asarray(w_np),
                             jnp.asarray(x_np)).compile().as_text()
    want = hlo.analyze_module(text).flops

    def tf(w, x):
        for i in range(L):
            x = x @ w[i]
        return x

    costs = op_census.analyze_module(tf, torch.from_numpy(w_np),
                                     torch.from_numpy(x_np))
    assert costs.flops == want == 2 * 4 * d * d * L
    assert dict(costs.flops_by_op) == {"aten.mm": costs.flops}


def test_convolution_equals_hlo():
    jax, jnp = _jax()
    from repro.analysis import hlo
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, 10, 3))
    k = rng.standard_normal((3, 3, 3, 5))

    def jf(x, k):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    text = jax.jit(jf).lower(jnp.asarray(x), jnp.asarray(k)).compile() \
        .as_text()
    want = hlo.analyze_module(text).flops
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    kt = torch.from_numpy(k).permute(3, 2, 0, 1)
    got = op_census.analyze_module(F.conv2d, xt, kt).flops
    assert got == want == 2 * 2 * 8 * 8 * 5 * 27
    # a transposed convolution counts each input element's products
    wt = torch.zeros(5, 3, 3, 3, dtype=F64)
    assert op_census.analyze_module(
        F.conv_transpose2d, torch.zeros(2, 5, 8, 8, dtype=F64), wt).flops \
        == 2 * 2 * 5 * 8 * 8 * 27


@pytest.mark.parametrize("op,args,flops", [
    ("mm", ((3, 4), (4, 5)), 2 * 3 * 4 * 5),
    ("bmm", ((2, 3, 4), (2, 4, 5)), 2 * 2 * 3 * 4 * 5),
    ("addmm", ((5,), (3, 4), (4, 5)), 2 * 3 * 4 * 5),
    ("baddbmm", ((2, 3, 5), (2, 3, 4), (2, 4, 5)), 2 * 2 * 3 * 4 * 5),
])
def test_product_flops(op, args, flops):
    tensors = [torch.ones(s, dtype=F64) for s in args]
    costs = op_census.analyze_module(getattr(torch, op), *tensors)
    assert costs.flops == flops
    assert costs.hbm_bytes == 8 * (sum(t.numel() for t in tensors)
                                   + flops // (2 * args[-2][-1]))


def test_bytes_follow_the_eager_rule():
    x = torch.zeros(128, 128, dtype=F64)

    def f(x):
        return torch.sum(torch.tanh(x) * 2.0 + 1.0)

    costs = op_census.analyze_module(f, x)
    n = x.numel() * 8
    # tanh, mul, add: read and write n each; sum: read n, write 8
    assert costs.hbm_bytes == 3 * 2 * n + n + 8
    assert costs.flops == 0
    # views and allocations move nothing; a broadcast axis counts once
    assert op_census.analyze_module(lambda t: t.T.unsqueeze(0)[:, :5],
                                    x).hbm_bytes == 0
    # a reshape that cannot be a view copies
    assert op_census.analyze_module(lambda t: t.T.reshape(-1),
                                    x).hbm_bytes == 2 * n
    assert op_census.analyze_module(torch.empty_like, x).hbm_bytes == 0
    row = torch.ones(1, 128, dtype=F64).expand(128, 128)
    assert op_census.analyze_module(torch.add, x, row).hbm_bytes == \
        2 * n + 128 * 8


def test_custom_calls_are_recorded_only_under_a_census():
    q = torch.zeros(2, 8, dtype=torch.bfloat16)
    out = torch.zeros(2, 8, dtype=torch.float32)
    op_census.record_custom_call("flash_attention", (q, q), out)  # no-op
    with op_census.Census() as outer:
        with op_census.Census() as inner:
            op_census.record_custom_call("flash_attention", (q, q), out)
        op_census.record_custom_call("rwkv_wkv", [q], out)
    assert dict(inner.costs.custom_calls) == {"flash_attention": 1}
    assert inner.costs.hbm_bytes == 2 * 32 + 64
    assert dict(outer.costs.custom_calls) == {"flash_attention": 1,
                                              "rwkv_wkv": 1}
    assert outer.costs.hbm_bytes == 2 * 32 + 64 + 32 + 64
    assert outer.costs.flops == 0
    with op_census.Census() as after:
        pass
    assert after.costs.hbm_bytes == 0 and not after.costs.custom_calls


def test_costs_add_and_cost_dict():
    a = op_census.Costs(flops=2.0, hbm_bytes=8.0)
    a.custom_calls["batched_cg"] += 1
    b = op_census.Costs()
    b.add(a, mult=3)
    assert (b.flops, b.hbm_bytes, dict(b.custom_calls)) == \
        (6.0, 24.0, {"batched_cg": 3})
    assert b.cost_dict() == {"flops": 6.0, "bytes accessed": 24.0}


def test_collectives_counted_by_kind(tmp_path):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        x = torch.ones(8, 4)

        def f(x):
            y = fc.all_reduce(x, "sum", dist.group.WORLD)
            return fc.wait_tensor(y).sum()

        got = op_census.collective_bytes(f, x)
        assert got == {"all-reduce": 128, "total": 128}
        assert op_census.collective_op_counts(f, x) == {"all-reduce": 1}

        def g(x):
            t = x.clone()
            dist.all_reduce(t)
            return t

        assert op_census.collective_op_counts(g, x) == {"all-reduce": 1}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with `pytest -m cuda` on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_ops_record_their_launches(cuda_device):
    from repro_torch.kernels.batched_cg import ops as cg_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q = torch.randn(2, 64, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    with torch.no_grad(), op_census.Census() as census:
        out = fa_ops.flash_attention(q, q, q, causal=True)
    assert dict(census.costs.custom_calls) == {"flash_attention": 1}
    assert census.costs.hbm_bytes >= 4 * out.numel() * out.element_size()
    A = torch.eye(16, device=cuda_device)[None].repeat(3, 1, 1)
    b = torch.ones(3, 16, device=cuda_device)
    with op_census.Census() as census:
        cg_ops.batched_cg(A, b)
    assert dict(census.costs.custom_calls) == {"batched_cg": 1}
    assert census.costs.hbm_bytes >= (A.numel() + 2 * b.numel()) * 4
