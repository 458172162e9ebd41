"""The port's WKV-6 op against the JAX op, and its kernel.

CPU: the port's op on CPU tensors (the plain sequential scan,
``ref.wkv_scan_ref``) against the JAX op ``wkv(..., interpret=True)`` — the
Pallas kernel body in interpret mode, as ``tests/test_kernels.py`` runs
it — at T ∈ {1, 64, 128}, with and without a carried ``state0``, float32
within 2e-5 (the same recurrence in float32; only the order of the sums
over i differs).  A state carried across a split of T equals one run over
the whole T.

The op hands the kernel r, k, v and w on 16-byte boundaries (a view at an
odd offset is copied first).

Card (``cuda`` marker; skipped without a CUDA device): the hand-written
kernel against the plain scan on the same CUDA tensors, float32 and
bfloat16 r/k/v (w always float32), with and without ``state0``, at T of
one short chunk (1, 5), whole chunks only (2048) and whole chunks and a
short one (37, 100, 130, 300) of the kernel's staging, and odd H::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_rwkv_wkv.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv_wkv import kernel, ops, ref

N = 64
ATOL = 2e-5


def _inputs(B, T, H, seed=0, with_state=False):
    """r, k, v ~ N(0, 0.25); w = exp(-exp(d)) with d = -6 + tanh(N(0, 1))
    as the model's decay; u ~ N(0, 0.01); state0 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)) for _ in range(3))
    w = np.exp(-np.exp(-6.0 + np.tanh(rng.standard_normal((B, T, H, N)))))
    u = 0.1 * rng.standard_normal((H, N))
    s0 = rng.standard_normal((B, H, N, N)) if with_state else None
    f32 = np.float32
    return (r.astype(f32), k.astype(f32), v.astype(f32), w.astype(f32),
            u.astype(f32), None if s0 is None else s0.astype(f32))


def _torch(arrays, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in arrays]


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state0"])
@pytest.mark.parametrize("T", [1, 64, 128])
def test_op_matches_jax_interpret_kernel(T, with_state):
    import jax.numpy as jnp
    from repro.kernels.rwkv_wkv.ops import wkv as jax_wkv
    arrays = _inputs(2, T, 3, seed=T, with_state=with_state)
    want_o, want_s = jax_wkv(*(None if a is None else jnp.asarray(a)
                               for a in arrays), interpret=True)
    got_o, got_s = ops.wkv(*_torch(arrays))
    assert got_o.dtype == torch.float32 and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=ATOL, rtol=ATOL)


def test_state_carried_across_a_split_of_t():
    r, k, v, w, u, s0 = _torch(_inputs(1, 40, 2, seed=7, with_state=True))
    o_all, s_all = ops.wkv(r, k, v, w, u, s0)
    o1, s1 = ops.wkv(r[:, :13], k[:, :13], v[:, :13], w[:, :13], u, s0)
    o2, s2 = ops.wkv(r[:, 13:], k[:, 13:], v[:, 13:], w[:, 13:], u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_all, rtol=0,
                               atol=0)
    torch.testing.assert_close(s2, s_all, rtol=0, atol=0)


def test_bf16_inputs_keep_their_type_and_w_stays_float32():
    r, k, v, w, u, _ = _torch(_inputs(1, 8, 2, seed=3))
    rb, kb, vb = (a.bfloat16() for a in (r, k, v))
    out, state = ops.wkv(rb, kb, vb, w, u)
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    want, want_s = ref.wkv_scan_ref(rb.float(), kb.float(), vb.float(), w, u)
    torch.testing.assert_close(out, want.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(state, want_s, rtol=0, atol=0)


@pytest.mark.parametrize("offset", [0, 1, 8])
def test_op_aligns_what_the_kernel_copies(offset):
    flat = torch.arange(offset + 2 * 3 * N, dtype=torch.bfloat16)
    view = flat[offset:].view(2, 3, 1, N)
    got = ops._aligned(view)
    assert got.data_ptr() % kernel.ALIGN == 0 and got.is_contiguous()
    assert torch.equal(got, view)
    if view.data_ptr() % kernel.ALIGN == 0:
        assert got.data_ptr() == view.data_ptr()    # no copy when aligned


def test_cpu_path_never_launches_and_device_rule():
    r, k, v, w, u, _ = _torch(_inputs(1, 4, 1))
    before = ops.LAUNCHES
    ops.wkv(r, k, v, w, u)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(r, k, v, w, u)


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
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state0"])
@pytest.mark.parametrize("B,T,H", [(1, 1, 1), (2, 100, 3), (2, 300, 40),
                                   (1, 5, 2), (1, 37, 1), (3, 130, 7),
                                   (1, 2048, 3)], ids=str)
def test_kernel_matches_plain_on_card(cuda_device, B, T, H, with_state,
                                      dtype):
    r, k, v, w, u, s0 = _torch(_inputs(B, T, H, seed=T, with_state=with_state),
                               cuda_device)
    r, k, v = (a.to(dtype) for a in (r, k, v))
    before = ops.LAUNCHES
    out, state = ops.wkv(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want, want_s = ref.wkv_scan_ref(r, k, v, w, u, s0)
    assert out.dtype == dtype and state.dtype == torch.float32
    err = (out.float() - want.float()).abs()
    assert bool((err <= _limit(want, dtype)).all()), float(err.max())
    s_err = float((state - want_s).abs().max())
    assert s_err <= 1e-4 * float(want_s.abs().max()), s_err


@pytest.mark.cuda
def test_kernel_state_carried_across_a_split_on_card(cuda_device):
    r, k, v, w, u, s0 = _torch(_inputs(2, 100, 3, seed=5, with_state=True),
                               cuda_device)
    o_all, s_all = ops.wkv(r, k, v, w, u, s0)
    o1, s1 = ops.wkv(r[:, :37], k[:, :37], v[:, :37], w[:, :37], u, s0)
    o2, s2 = ops.wkv(r[:, 37:], k[:, 37:], v[:, 37:], w[:, 37:], u, s1)
    torch.cuda.synchronize()
    # the same arithmetic in the same order: bit for bit
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_all, rtol=0, atol=0)
    torch.testing.assert_close(s2, s_all, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    r, k, v, w, u, _ = _torch(_inputs(1, 4, 1), cuda_device)
    with pytest.raises(ValueError, match="head size"):
        ops.wkv(r[..., :32], k[..., :32], v[..., :32], w[..., :32],
                u[..., :32])
    with pytest.raises(TypeError):
        ops.wkv(r.bfloat16(), k, v, w, u)


@pytest.mark.cuda
def test_kernel_takes_views_at_an_odd_offset_on_card(cuda_device):
    r, k, v, w, u, _ = _torch(_inputs(1, 20, 2, seed=9), cuda_device)
    r, k, v = (a.bfloat16() for a in (r, k, v))

    def shifted(a):        # the same values, 2 bytes past an aligned start
        flat = torch.cat([a.new_zeros(1), a.flatten()])
        return flat[1:].view(a.shape)

    rs, ks, vs = (shifted(a) for a in (r, k, v))
    assert rs.data_ptr() % kernel.ALIGN != 0
    out, state = ops.wkv(rs, ks, vs, w, u)
    torch.cuda.synchronize()
    want, want_s = ops.wkv(r, k, v, w, u)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(state, want_s, rtol=0, atol=0)
