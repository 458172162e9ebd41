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

Card (``cuda`` marker; skipped without a CUDA device): the hand-written
kernel against the plain version on the same CUDA tensors, float32 and
bfloat16, at GQA, MQA, ragged tiles, Sq ≠ Sk and D ∈ {64, 80, 128, 256}::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_flash_attention.py
"""
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [
    (2, 128, 128, 4, 4, 64), (2, 200, 200, 8, 2, 128), (1, 77, 77, 4, 1, 80),
    (1, 64, 130, 2, 2, 256), (3, 33, 17, 6, 3, 64), (1, 1, 1, 1, 1, 64)],
    ids=str)
def test_kernel_matches_plain_on_card(cuda_device, B, Sq, Sk, H, Hkv, D,
                                      causal, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(B, Sq, Sk, H, Hkv, D, seed=D))
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
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
