"""The port's RWKV-6 blocks against ``repro.models.rwkv``.

Time mixing and channel mixing on the same numpy inputs and parameters in
both packages, in float32, within 1e-5 (2e-5 through the recurrence): with
and without a carried state, at T = 1 and 5 (the sequential scan), T = 64
(the chunked path) and through the WKV op against the JAX kernel in
interpret mode (``use_kernel=True``).  The LoRA factors that the reference
initialises to zero are random here, so that the data-dependent mixing and
decay are exercised.  ``wkv_chunked`` at T ∈ {64, 128} against the JAX one.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jcfgs
from repro.models import rwkv as JR
from repro_torch import configs
from repro_torch.models import rwkv as TR

ATOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jcfgs.get("rwkv6-3b", smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(configs.get("rwkv6-3b", smoke=True),
                               dtype="float32")
    key = jax.random.PRNGKey(0)
    tm = jax.tree_util.tree_map(np.asarray, JR.time_mix_init(key, jcfg))
    cm = jax.tree_util.tree_map(np.asarray,
                                JR.channel_mix_init(key, jcfg))
    rng = np.random.default_rng(0)
    for name in ("mix_lora_b", "decay_lora_b"):
        tm[name] = (0.1 * rng.standard_normal(tm[name].shape)).astype(
            np.float32)
    return jcfg, tcfg, tm, cm


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                   tree))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=atol)


@pytest.fixture
def jax_wkv_interpret(monkeypatch):
    """Run the JAX WKV op in interpret mode on the CPU."""
    import repro.kernels.rwkv_wkv.ops as wkv_ops
    orig = wkv_ops.wkv
    monkeypatch.setattr(wkv_ops, "wkv",
                        lambda r, k, v, w, u, state0=None: orig(
                            r, k, v, w, u, state0, interpret=True))


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("T,use_kernel", [
    (1, False), (5, False), (64, False),   # scan, scan, chunked
    (1, True), (64, True)],                # the JAX op needs T % min(64, T)
    ids=["T1", "T5", "T64", "T1-kernel", "T64-kernel"])
def test_time_mix(setup, T, use_kernel, with_state, jax_wkv_interpret):
    jcfg, tcfg, tm, _ = setup
    rng = np.random.default_rng(T)
    d, H = tcfg.d_model, tcfg.d_model // 64
    x = rng.standard_normal((2, T, d)).astype(np.float32)
    state = (rng.standard_normal((2, d)).astype(np.float32),
             rng.standard_normal((2, H, 64, 64)).astype(np.float32)) \
        if with_state else None
    (xj, pj, sj), (xt, pt, st) = _both((x, tm, state))
    want, (wx, ws) = JR.time_mix_apply(pj, jcfg, xj, state=sj,
                                       use_kernel=use_kernel)
    got, (gx, gs) = TR.time_mix_apply(pt, tcfg, xt, state=st,
                                      use_kernel=use_kernel)
    _close(got, want)
    _close(gx, wx, atol=0)
    _close(gs, ws)


@pytest.mark.parametrize("with_prev", [False, True], ids=["fresh", "prev"])
def test_channel_mix_and_token_shift(setup, with_prev):
    jcfg, tcfg, _, cm = setup
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, tcfg.d_model)).astype(np.float32) \
        if with_prev else None
    (xj, pj, vj), (xt, pt, vt) = _both((x, cm, prev))
    want, wl = JR.channel_mix_apply(pj, jcfg, xj, x_prev=vj)
    got, gl = TR.channel_mix_apply(pt, tcfg, xt, x_prev=vt)
    _close(got, want, atol=1e-5)
    _close(gl, wl, atol=0)
    _close(TR.token_shift(xt, vt), JR.token_shift(xj, vj), atol=0)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("T", [64, 128])
def test_wkv_chunked(T, with_state):
    rng = np.random.default_rng(T)
    B, H, N = 2, 3, 64
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)) for _ in range(3))
    w = np.exp(-np.exp(-6.0 + np.tanh(rng.standard_normal((B, T, H, N)))))
    u = 0.1 * rng.standard_normal((H, N))
    s0 = rng.standard_normal((B, H, N, N)) if with_state else None
    arrays = tuple(None if a is None else a.astype(np.float32)
                   for a in (r, k, v, w, u, s0))
    (aj, at) = _both(arrays)
    want, ws = JR.wkv_chunked(*aj)
    got, gs = TR.wkv_chunked(*at)
    _close(got, want, atol=1e-5)
    _close(gs, ws, atol=1e-5)
    # and the chunked schedule against the sequential scan, as the
    # reference's own test holds it
    ref, rs = TR.wkv_scan_ref(*at)
    _close(got, ref.numpy(), atol=2e-4)
    _close(gs, rs.numpy(), atol=2e-4)


def test_state_init():
    tcfg = configs.get("rwkv6-3b", smoke=True)
    x_tm, wkv, x_cm = TR.rwkv_state_init(tcfg, 3, device="cpu")
    assert x_tm.shape == x_cm.shape == (3, 128)
    assert x_tm.dtype == torch.bfloat16 and wkv.dtype == torch.float32
    assert wkv.shape == (3, 2, 64, 64) and not wkv.any()
