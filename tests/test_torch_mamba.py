"""The port's Mamba-2 block (``repro_torch.models.mamba``) against
``repro.models.mamba``.

The same numpy inputs and parameters in both packages, ``zamba2-7b-smoke``
(d 128, d_inner 256, 8 heads of P 32, Nst 16, conv width 4):

  * ``_causal_conv`` with and without a carried state, float32 within
    1e-5; bfloat16 bit for bit before the SiLU (the K shifted products
    summed in the reference's order) and within two roundings after it;
  * ``ssd_scan_ref`` at T = 128 (two chunks of 64) with ``state0``, at
    T = 48 (the chunk ``mamba_apply`` picks: gcd(48, 64) = 16) and at
    T = 1, float32 within 1e-4;
  * ``mamba_apply`` prefill and a step from a carried state against the
    JAX one (float32 1e-4; a prompt shorter than the conv's K − 1 rows
    computes what the reference computes), and the port's token-by-token
    decode against its own prefill;
  * ``mamba_init`` and ``mamba_state_init``: trees, shapes and types.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jcfgs
from repro.models import mamba as JMa
from repro_torch import configs
from repro_torch.interop import _leaf_to_tensor
from repro_torch.models import mamba as TMa

ARCH = "zamba2-7b"


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jcfgs.get(ARCH, smoke=True), dtype=dtype),
            dataclasses.replace(configs.get(ARCH, smoke=True), dtype=dtype))


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(tree, dtype="float32"):
    """numpy pytree -> (jax tree, torch tree), float arrays cast to
    ``dtype``."""
    def j(a):
        a = jnp.asarray(a)
        return a.astype(jnp.dtype(dtype)) if a.dtype == jnp.float32 else a

    def t(a):
        a = torch.from_numpy(np.array(a))
        return a.to(getattr(torch, dtype)) if a.dtype == torch.float32 \
            else a
    return (jax.tree_util.tree_map(j, tree), jax.tree_util.tree_map(t, tree))


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
def test_causal_conv(with_state, dtype, monkeypatch):
    rng = np.random.default_rng(0)
    x, w, b = _np(rng, 2, 9, 12), _np(rng, 4, 12, scale=0.3), _np(rng, 12)
    state = _np(rng, 2, 3, 12) if with_state else None
    (xj, wj, bj, sj), (xt, wt, bt, st) = _both((x, w, b, state), dtype)
    yj, nj = JMa._causal_conv(xj, wj, bj, sj)
    yt, nt = TMa._causal_conv(xt, wt, bt, st)
    assert yt.dtype == getattr(torch, dtype) and nt.shape == (2, 3, 12)
    _close(nt, nj, atol=0)                    # the trailing K−1 inputs
    if dtype == "float32":
        _close(yt, yj, atol=1e-5)
        return
    # bfloat16: XLA's SiLU rounds the sigmoid before the product, PyTorch's
    # rounds once, so the outputs are two roundings (2⁻⁶ of the value)
    # apart; before the SiLU, the K rounded products and the bias are
    # summed in the same order, bit for bit
    want = np.asarray(yj, np.float32)
    err = np.abs(yt.float().numpy() - want)
    assert (err <= 2.0 ** -6 * np.abs(want)).all()
    monkeypatch.setattr(jax.nn, "silu", lambda v: v)
    monkeypatch.setattr(TMa.F, "silu", lambda v: v)
    _close(TMa._causal_conv(xt, wt, bt, st)[0],
           JMa._causal_conv(xj, wj, bj, sj)[0], atol=0)


@pytest.mark.parametrize("T,chunk,with_state", [(128, 64, True),
                                                (48, 16, False),
                                                (1, 1, True)],
                         ids=["T128_state0", "T48_gcd_chunk", "T1"])
def test_ssd_scan_matches_jax(T, chunk, with_state):
    rng = np.random.default_rng(1)
    Bb, H, P, N = 2, 3, 8, 5
    x = _np(rng, Bb, T, H, P, scale=0.5)
    a = -np.abs(_np(rng, Bb, T, H, scale=0.3))
    B, C = _np(rng, Bb, T, N), _np(rng, Bb, T, N)
    D = _np(rng, H)
    s0 = _np(rng, Bb, H, N, P) if with_state else None
    (jargs), (targs) = _both((x, a, B, C, D, s0))
    yj, sj = JMa.ssd_scan_ref(*jargs, chunk=chunk)
    yt, st = TMa.ssd_scan_ref(*targs, chunk=chunk)
    assert yt.shape == (Bb, T, H, P) and st.shape == (Bb, H, N, P)
    assert st.dtype == torch.float32
    _close(yt, yj)
    _close(st, sj)


def _block_params(seed=2):
    jcfg, tcfg = _cfgs()
    jp = jax.tree_util.tree_map(np.asarray,
                                JMa.mamba_init(jax.random.PRNGKey(seed),
                                               jcfg))
    # a nonzero conv bias and dt bias, so that both are exercised
    rng = np.random.default_rng(seed)
    jp = dict(jp, conv_b=_np(rng, *jp["conv_b"].shape, scale=0.1),
              dt_bias=_np(rng, *jp["dt_bias"].shape, scale=0.5))
    tp = jax.tree_util.tree_map(lambda a: _leaf_to_tensor(a, "cpu"), jp)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, jp), tp


@pytest.mark.parametrize("T,with_state", [(64, False), (48, True),
                                          (1, True), (2, False)],
                         ids=["T64", "T48_state", "T1_decode",
                              "T2_short_prompt"])
def test_mamba_apply_matches_jax(T, with_state):
    """Prefill (no state) and a step from a carried state.  A prompt
    shorter than conv_width − 1 with no state (T = 2) gets a zero pad of
    T rows, not K − 1, in the reference, and the port computes the same
    (ROADMAP C); at T = 1 without a state both raise."""
    jcfg, tcfg, jp, tp = _block_params()
    rng = np.random.default_rng(3)
    x = _np(rng, 2, T, tcfg.d_model)
    conv_dim = tp["conv_w"].shape[1]
    state = (_np(rng, 2, 3, conv_dim, scale=0.5),
             _np(rng, 2, 8, 16, 32, scale=0.5)) if with_state else None
    (xj, sj), (xt, st) = _both((x, state))
    yj, (cj, sj) = JMa.mamba_apply(jp, jcfg, xj, state=sj)
    yt, (ct, st) = TMa.mamba_apply(tp, tcfg, xt, state=st)
    _close(yt, yj)
    _close(ct, cj, atol=1e-5)
    _close(st, sj)


def test_one_token_prefill_without_state_raises_in_both():
    jcfg, tcfg, jp, tp = _block_params()
    x = _np(np.random.default_rng(5), 2, 1, tcfg.d_model)
    with pytest.raises(TypeError):
        JMa.mamba_apply(jp, jcfg, jnp.asarray(x))
    with pytest.raises(RuntimeError):
        TMa.mamba_apply(tp, tcfg, torch.from_numpy(x))


def test_mamba_decode_matches_own_prefill():
    """Token by token with the carried (conv, ssm) state against one
    prefill over the same 24 tokens, and a state carried across a split
    of T (16 + 8) against one run."""
    _, tcfg, _, tp = _block_params()
    x = torch.from_numpy(_np(np.random.default_rng(4), 2, 24,
                             tcfg.d_model))
    full, (conv_f, ssm_f) = TMa.mamba_apply(tp, tcfg, x)
    state = TMa.mamba_state_init(tcfg, 2, device="cpu")
    outs = []
    for t in range(24):
        y, state = TMa.mamba_apply(tp, tcfg, x[:, t:t + 1], state=state)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(state[1], ssm_f, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(state[0], conv_f)
    y1, s1 = TMa.mamba_apply(tp, tcfg, x[:, :16])
    y2, s2 = TMa.mamba_apply(tp, tcfg, x[:, 16:], state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), full, atol=1e-4,
                               rtol=1e-4)


def test_mamba_init_and_state_shapes():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = JMa.mamba_init(jax.random.PRNGKey(0), jcfg)
    tp = TMa.mamba_init(torch.Generator().manual_seed(0), tcfg, device="cpu")

    def sig(tree):
        return {k: sig(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    assert sig(tp) == sig(jp)
    _close(tp["A_log"], jp["A_log"], atol=1e-6)
    assert torch.equal(tp["D"], torch.ones_like(tp["D"]))
    want = JMa.mamba_state_init(jcfg, 3)
    got = TMa.mamba_state_init(tcfg, 3, device="cpu")
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in got] == \
        [(w.shape, str(w.dtype)) for w in want]
    assert not any(t.any() for t in got)
    if not torch.cuda.is_available():          # the default is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TMa.mamba_state_init(tcfg, 1)
