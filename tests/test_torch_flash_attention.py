"""The port's flash-attention op against the JAX op, and its kernel.

CPU: the port's op on CPU tensors (its plain version, ``ref.attention_ref``
with top-left causal alignment) against the JAX op
``flash_attention(..., interpret=True)`` — the Pallas kernel body in
interpret mode, as ``tests/test_kernels.py`` runs it — at (B, S, H, Hkv, D)
with S ∈ {64, 128, 256}, GQA groups of 2 (4/2) and 4 (8/2), causal and not,
float32 within 1e-5 and bfloat16 within 2e-2 absolute and relative (both
compute in float32; in bfloat16 the outputs are at most one rounding
apart, one bf16 unit = 2⁻⁷ of the value at most).  The port's
``attention_ref`` against the JAX ``attention_ref`` at Sq = Sk, and its
top-left mask against the JAX model's ``_sdpa`` at Sq ≠ Sk, where the JAX
ref is bottom-right.

CPU, the routes: ``kernel.route`` sends bfloat16 with D a multiple of 8 in
[64, 256] and 16-byte aligned views to the tensor-core kernel (``"tc"``)
and float32, narrow heads and misaligned views to the CUDA-core kernel
(``"simt"``); the per-route launch counts stay 0 on CPU tensors.  The tc
route's P handling, emulated in plain PyTorch on the CPU: one bf16
rounding of P breaks the bf16 kernel-against-plain limit, the two-term
(hi + lo) P that the kernel uses holds it.

Card (``cuda`` marker; skipped without a CUDA device): the hand-written
kernels against the plain version on the same CUDA tensors, float32 and
bfloat16 through the op and bfloat16 on the CUDA-core kernel, at GQA, MQA,
ragged tiles, Sq ≠ Sk and D ∈ {32, 64, 80, 128, 256};
the tc route alone at those shapes plus D = 192 and Sq = 2048 and on a
strided (fused-QKV) view; the tc and simt routes against each other; one
launch of the prefill shape counted on the tc route::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_flash_attention.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel, ops, ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(B, Sq, Sk, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32))


def _jax():
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import flash_attention
    return jnp, flash_attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (8, 2)], ids=["gqa4/2", "gqa8/2"])
@pytest.mark.parametrize("S", [64, 128, 256])
def test_op_matches_jax_interpret_kernel(S, H, Hkv, causal, dtype):
    jnp, jax_fa = _jax()
    q, k, v = _qkv(1, S, S, H, Hkv, 32, seed=S + H)
    want = jax_fa(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                  causal=causal, interpret=True)
    tdt = getattr(torch, dtype)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), causal=causal)
    assert got.dtype == tdt and got.shape == (1, S, H, 32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("Sq,Sk", [(8, 24), (24, 24)])
def test_ref_matches_jax_ref_and_op_is_top_left(Sq, Sk):
    """At Sq = Sk the port's ``attention_ref`` equals the JAX
    ``attention_ref``; at Sq ≠ Sk the port keeps the TPU kernel's top-left
    mask, which the JAX model's ``_sdpa`` has too (the JAX ref's is
    bottom-right there)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    from repro.models.layers import _sdpa as jax_sdpa
    q, k, v = _qkv(2, Sq, Sk, 4, 2, 16, seed=1)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    plain = ref.attention_ref(qt, kt, vt, causal=True)
    if Sq == Sk:
        kr, vr = (np.repeat(a, 2, axis=2) for a in (k, v))
        want = jax_ref(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
                       causal=True)
    else:
        want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=1e-5)
    top_left = ops.flash_attention(qt, kt, vt, causal=True)
    torch.testing.assert_close(top_left, plain, rtol=0, atol=0)
    # query i sees keys j <= i: the first query row attends to key 0 only
    torch.testing.assert_close(top_left[:, 0], vt[:, 0].repeat_interleave(
        2, dim=1), rtol=1e-6, atol=1e-6)


def test_cpu_path_never_launches_and_device_rule():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 8))
    before = ops.LAUNCHES
    ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(q, k, v)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("D", [64, 80, 128, 192, 256])
def test_route_sends_aligned_bf16_to_tensor_cores(D):
    q, kv = _bf16(2, 16, 4, D), _bf16(2, 16, 2, D)
    assert kernel.route(q, kv, kv) == "tc"
    # a strided view (q of a fused QKV projection) is read in place
    fused = _bf16(2, 16, 4, 3 * D)
    assert kernel.route(fused[..., :D], fused[..., D:2 * D],
                        fused[..., 2 * D:]) == "tc"


@pytest.mark.parametrize("case", ["float32", "bf16 D=8", "bf16 D=16",
                                  "bf16 D=72+4", "misaligned bf16 view"])
def test_route_sends_the_rest_to_cuda_cores(case):
    if case == "float32":
        q = torch.zeros(1, 8, 2, 128)
    elif case == "misaligned bf16 view":
        flat = torch.zeros(8 * 2 * 128 + 1, dtype=torch.bfloat16)
        q = flat[1:].view(1, 8, 2, 128)
        assert q.data_ptr() % 16 != 0
    elif case == "bf16 D=72+4":     # D not a multiple of 8
        q = _bf16(1, 8, 2, 76)
    else:
        q = _bf16(1, 8, 2, int(case.split("=")[1]))
    assert kernel.route(q, q, q) == "simt"


def test_route_raises_on_what_no_kernel_takes():
    with pytest.raises(ValueError, match="D <="):
        kernel.route(*(_bf16(1, 8, 2, 264) for _ in range(3)))
    with pytest.raises(ValueError, match="H % Hkv"):
        kernel.route(_bf16(1, 8, 3, 64), _bf16(1, 8, 2, 64),
                     _bf16(1, 8, 2, 64))
    with pytest.raises(TypeError):
        kernel.route(*(torch.zeros(1, 8, 2, 64, dtype=torch.float16)
                       for _ in range(3)))


def test_route_counts_stay_zero_on_cpu():
    before = dict(ops.LAUNCHES_BY_ROUTE)
    assert set(before) == {"tc", "simt"}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in _qkv(1, 16, 16, 4, 2, 64))
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES_BY_ROUTE == before


def _tc_emulated(q, k, v, causal, block_n, two_terms):
    """The tc kernel's numerics in plain PyTorch: float32 logits and
    online softmax over key tiles of ``block_n``, P rounded to bf16 for the
    PV product (as hi + lo when ``two_terms``), l summed unrounded."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kr, vr = (t.float().repeat_interleave(H // Hkv, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / math.sqrt(D)
    if causal:
        s = torch.where(torch.arange(Sk)[None, :]
                        <= torch.arange(Sq)[:, None], s, ref.NEG_INF)
    m = torch.full((B, H, Sq, 1), ref.NEG_INF)
    acc, l = torch.zeros(B, H, Sq, D), torch.zeros(B, H, Sq, 1)
    for k0 in range(0, Sk, block_n):
        st = s[..., k0:k0 + block_n]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(st - m_new)
        hi = p.bfloat16().float()
        pv = hi + (p - hi).bfloat16().float() if two_terms else hi
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhqk,bkhd->bhqd", pv,
                                         vr[:, k0:k0 + block_n])
        m = m_new
    return (acc / l).permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("two_terms", [False, True],
                         ids=["one bf16 term", "hi + lo"])
def test_tc_p_in_two_bf16_terms_holds_the_bf16_limit(two_terms):
    """Why the tc kernel carries P as hi + lo: with one bf16 rounding of
    P, about 1 % of the outputs of a GQA causal attention over 200 keys
    fall outside 2⁻⁷|ref| + 1e-4·max|ref|; with two terms none do."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(2, 200, 200, 8, 2, 128, seed=3))
    want = ref.attention_ref(q, k, v, causal=True)
    got = _tc_emulated(q, k, v, True, 128, two_terms)
    over = int(((got.float() - want.float()).abs()
                > _limit(want, torch.bfloat16)).sum())
    if two_terms:
        assert over == 0
    else:
        assert over > 100


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with `pytest -m cuda` on the "
                    "card)")
    return torch.device("cuda")


def _limit(want, dtype):
    """float32: 1e-4 of the largest |output| (sums in another order);
    bfloat16: one rounding of the output (at most one bf16 unit, 2⁻⁷ of
    the value) plus that."""
    big = float(want.float().abs().max())
    if dtype == torch.float32:
        return 1e-4 * big
    return 2.0 ** -7 * want.float().abs() + 1e-4 * big


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route_name", [
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, "simt")],
    ids=["f32", "bf16", "bf16-simt"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [
    (2, 128, 128, 4, 4, 64), (2, 200, 200, 8, 2, 128), (1, 77, 77, 4, 1, 80),
    (1, 64, 130, 2, 2, 256), (3, 33, 17, 6, 3, 64), (1, 1, 1, 1, 1, 64),
    (2, 100, 100, 4, 2, 32)], ids=str)
def test_kernel_matches_plain_on_card(cuda_device, B, Sq, Sk, H, Hkv, D,
                                      causal, dtype, route_name):
    """Through the op (the route it picks, counted once), and in bfloat16
    also on the CUDA-core kernel whatever the op would pick."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(B, Sq, Sk, H, Hkv, D, seed=D))
    if route_name is None:
        before = dict(ops.LAUNCHES_BY_ROUTE, total=ops.LAUNCHES)
        took = kernel.route(q, k, v)
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == before["total"] + 1
        assert ops.LAUNCHES_BY_ROUTE[took] == before[took] + 1
    else:
        got = kernel.launch(q, k, v, causal, route_name=route_name)
        torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    assert bool((err <= _limit(want, dtype)).all()), float(err.max())


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(1, 8, 8, 3, 2, 8))
    with pytest.raises(ValueError, match="H % Hkv"):
        ops.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(1, 8, 8, 2, 2, 300))
    with pytest.raises(ValueError, match="D <="):
        ops.flash_attention(q, k, v)
    q = q[..., :8].double()
    with pytest.raises(TypeError):
        ops.flash_attention(q, k[..., :8].double(), v[..., :8].double())


_TC_SHAPES = [(2, 128, 128, 4, 4, 64), (2, 200, 200, 8, 2, 128),
              (1, 77, 77, 4, 1, 80), (1, 64, 130, 2, 2, 256),
              (3, 33, 17, 6, 3, 64), (1, 1, 1, 1, 1, 64),
              (1, 64, 130, 2, 2, 192), (1, 2048, 2048, 4, 2, 128)]


def _bf16_on(device, B, Sq, Sk, H, Hkv, D):
    return tuple(torch.from_numpy(a).to(device, torch.bfloat16)
                 for a in _qkv(B, Sq, Sk, H, Hkv, D, seed=D + Sq))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", _TC_SHAPES, ids=str)
def test_tc_route_matches_plain_on_card(cuda_device, B, Sq, Sk, H, Hkv, D,
                                        causal):
    q, k, v = _bf16_on(cuda_device, B, Sq, Sk, H, Hkv, D)
    assert kernel.route(q, k, v) == "tc"
    got = kernel.launch(q, k, v, causal, route_name="tc")
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs()
    assert bool((err <= _limit(want, torch.bfloat16)).all()), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", _TC_SHAPES[:6], ids=str)
def test_tc_and_simt_routes_agree_on_card(cuda_device, B, Sq, Sk, H, Hkv, D,
                                          causal):
    q, k, v = _bf16_on(cuda_device, B, Sq, Sk, H, Hkv, D)
    tc = kernel.launch(q, k, v, causal, route_name="tc")
    simt = kernel.launch(q, k, v, causal, route_name="simt")
    torch.cuda.synchronize()
    err = (tc.float() - simt.float()).abs()
    assert bool((err <= _limit(simt, torch.bfloat16)).all()), \
        float(err.max())


@pytest.mark.cuda
def test_tc_route_reads_a_fused_qkv_view_in_place(cuda_device):
    B, S, H, D = 2, 130, 4, 128
    fused = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, S, H, 3 * D)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = fused[..., :D], fused[..., D:2 * D], fused[..., 2 * D:]
    before = dict(ops.LAUNCHES_BY_ROUTE)
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_ROUTE["tc"] == before["tc"] + 1
    want = ref.attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True)
    err = (got.float() - want.float()).abs()
    assert bool((err <= _limit(want, torch.bfloat16)).all()), \
        float(err.max())


@pytest.mark.cuda
def test_prefill_shape_counts_one_tc_launch(cuda_device):
    """qwen1.5-4b's prefill attention, (4, 2048, 20, 128) bf16 causal:
    one launch, counted on the tc route and nowhere else."""
    q, k, v = _bf16_on(cuda_device, 4, 2048, 2048, 20, 20, 128)
    before, total = dict(ops.LAUNCHES_BY_ROUTE), ops.LAUNCHES
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == total + 1
    assert ops.LAUNCHES_BY_ROUTE == {"tc": before["tc"] + 1,
                                     "simt": before["simt"]}
    assert bool(torch.isfinite(out.float()).all())
