"""The port's optimizers, schedules and gradient compression against
``repro.optim``.

  * ``adamw``, ``lion``, ``sgd`` (plain and Nesterov) over 5 steps on a
    quadratic (each package's own gradient) and on a smoke model's
    parameters (the same numpy gradients fed to both), float32, within
    1e-6; the port updates its state in place;
  * every schedule at steps 0 … total within 1e-7;
  * ``global_norm`` and ``clip_by_global_norm`` (in place);
  * ``roundtrip``, ``compress_tree`` and ``decompress_tree`` with their
    error state, equal to the reference's bit for bit (the same float32
    operations, rounding half to even in both);
  * the reference's own ``TestOptimizers`` and ``TestGradCompression``
    properties (``tests/test_runtime.py``), run on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from conftest import require_hypothesis

require_hypothesis()
from hypothesis import given, settings, strategies as st

from repro import configs as jcfgs
from repro import models as JM
from repro import optim as jopt
from repro_torch import configs, interop
from repro_torch import optim as topt
from repro_torch.models import init_params
from repro_torch.optim import grad_compression as tgc
from repro.optim import grad_compression as jgc

TOL = 1e-6
F32 = torch.float32

OPTIMIZERS = {
    "adamw": dict(lr=1e-2, weight_decay=0.1),
    "lion": dict(lr=1e-3, weight_decay=0.1),
    "sgd": dict(lr=1e-2, momentum=0.9),
    "sgd_nesterov": dict(lr=1e-2, momentum=0.9, nesterov=True),
}


def _pair(name):
    kw = dict(OPTIMIZERS[name])
    make = name.split("_")[0]
    return getattr(jopt, make)(**kw), getattr(topt, make)(**kw)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jleaves(port_tree):
    """The leaves of a port tree as numpy, in the JAX package's order (its
    dict keys sorted; PyTorch's pytree keeps insertion order)."""
    return jax.tree_util.tree_leaves(pytree.tree_map(_np, port_tree))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_on_a_quadratic_matches_reference(name):
    jo, to = _pair(name)
    Q = np.diag([1.0, 5.0, 10.0]).astype(np.float32)
    xj = jnp.ones(3, jnp.float32)
    xt = torch.ones(3, dtype=F32)
    sj, st_ = jo.init(xj), to.init(xt)
    for _ in range(5):
        gj = jnp.asarray(Q) @ xj
        gt = torch.as_tensor(Q) @ xt
        uj, sj = jo.update(gj, sj, xj)
        ut, st2 = to.update(gt, st_, xt)
        assert st2 is st_                          # updated in place
        xj = jopt.apply_updates(xj, uj)
        assert topt.apply_updates(xt, ut) is xt
        np.testing.assert_allclose(_np(xt), _np(xj), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_np(st_.mu), _np(sj.mu), rtol=TOL,
                                   atol=TOL)
    assert int(st_.step) == int(sj.step) == 5
    assert st_.step.dtype == torch.int32


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_on_model_params_matches_reference(name):
    jcfg = dataclasses.replace(jcfgs.get("llama3-405b", smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(configs.get("llama3-405b", smoke=True),
                               dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   tcfg, device="cpu")
    jo, to = _pair(name)
    sj, st_ = jo.init(jp), to.init(tp)
    rng = np.random.default_rng(1)

    @jax.jit
    def jstep(g, sj, jp):
        uj, sj = jo.update(g, sj, jp)
        return jopt.apply_updates(jp, uj), sj

    for _ in range(5):
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
        jp, sj = jstep(g, sj, jp)
        ut, st_ = to.update(interop.params_from_numpy(g, tcfg, "cpu"), st_,
                            tp)
        tp = topt.apply_updates(tp, ut)
    for got, want in zip(
            jax.tree_util.tree_leaves(interop.params_to_numpy(tp)),
            jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL,
                                   atol=TOL)
    moments = [(st_.mu, sj.mu)] + ([(st_.nu, sj.nu)] if sj.nu is not None
                                   else [])
    for got, want in moments:
        for a, b in zip(jax.tree_util.tree_leaves(
                interop.params_to_numpy(got)),
                jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL,
                                       atol=TOL)


SCHEDULES = {
    "constant": (dict(lr=3e-3), 50),
    "linear_warmup_cosine": (dict(lr=3e-3, warmup=10, total=100), 100),
    "linear_warmup_cosine_frac": (dict(lr=1.0, warmup=0, total=37,
                                       final_frac=0.3), 37),
    "inverse_sqrt": (dict(lr=1e-2, warmup=16), 100),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    kw, total = SCHEDULES[name]
    fn = name.replace("_frac", "")
    js = getattr(jopt.schedules, fn)(**kw)
    ts = getattr(topt.schedules, fn)(**kw)
    for step in range(total + 2):
        got = ts(torch.tensor(step, dtype=torch.int32))
        want = js(jnp.asarray(step, jnp.int32))
        assert got.dtype == F32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-7,
                                   atol=1e-7)


def _random_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": (3 * rng.standard_normal((37, 5))).astype(dtype),
            "blocks": [{"a": rng.standard_normal(4100).astype(dtype)},
                       {"a": np.zeros(4100, dtype)}],
            "b": rng.standard_normal(()).astype(dtype)}


def _t(tree):
    return pytree.tree_map(lambda a: torch.tensor(a), tree)


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_global_norm_and_clip_match_reference(max_norm):
    tree = _random_tree(0)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = _t(tree)
    np.testing.assert_allclose(float(topt.global_norm(tt)),
                               float(jopt.global_norm(jt)), rtol=1e-6)
    jc, jn = jopt.clip_by_global_norm(jt, max_norm)
    tc, tn = topt.clip_by_global_norm(tt, max_norm)
    assert tc is tt                                # scaled in place
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(_jleaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


def test_clip_rounds_bf16_grads_as_the_reference():
    rng = np.random.default_rng(2)
    g = (10 * rng.standard_normal(300)).astype(np.float32)
    gt = torch.tensor(g).to(torch.bfloat16)
    gj = jnp.asarray(g).astype(jnp.bfloat16)
    (tc,), _ = topt.clip_by_global_norm([gt], 1.0)
    (jc,), _ = jopt.clip_by_global_norm([gj], 1.0)
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 1])
def test_roundtrip_matches_reference(seed):
    tree = _random_tree(seed)
    jerr = jgc.init_error_state(jax.tree_util.tree_map(jnp.asarray, tree))
    terr = tgc.init_error_state(_t(tree))
    for step in range(3):
        g = _random_tree(seed + 10 * step)
        jout, jerr = jgc.roundtrip(jax.tree_util.tree_map(jnp.asarray, g),
                                   jerr)
        tg = _t(g)
        tout, terr2 = tgc.roundtrip(tg, terr)
        assert tout is tg and terr2 is terr        # written in place
        for a, b in zip(_jleaves(tout), jax.tree_util.tree_leaves(jout)):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(_jleaves(terr), jax.tree_util.tree_leaves(jerr)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_compress_and_decompress_match_reference():
    tree = _random_tree(3)
    jg = jax.tree_util.tree_map(jnp.asarray, tree)
    tg = _t(tree)
    jerr = jax.tree_util.tree_map(lambda a: 0.01 * jnp.ones(a.shape,
                                                            jnp.float32), jg)
    terr = pytree.tree_map(lambda a: 0.01 * torch.ones(a.shape), tg)
    jc, jerr = jgc.compress_tree(jg, jerr)
    tc, terr2 = tgc.compress_tree(tg, terr)
    assert terr2 is terr
    assert all(c.q.dtype == torch.int8 for c in pytree.tree_leaves(
        tc, is_leaf=lambda x: isinstance(x, tgc.Compressed)))
    # a Compressed is a named tuple in both packages: its leaves q, scale
    for a, b in zip(_jleaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(_jleaves(terr), jax.tree_util.tree_leaves(jerr)):
        np.testing.assert_array_equal(a, np.asarray(b))
    jd = jgc.decompress_tree(jc, jg)
    td = tgc.decompress_tree(tc, tg)
    for a, b in zip(_jleaves(td), jax.tree_util.tree_leaves(jd)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_rounding_is_half_to_even_in_both():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    tq = tgc._quantize(torch.tensor(x), chunk=8)
    jq = jgc._quantize(jnp.asarray(x), chunk=8)
    np.testing.assert_array_equal(_np(tq.q), np.asarray(jq.q))


# ---------------------------------------------------------------------------
# the reference's TestOptimizers and TestGradCompression, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: topt.adamw(0.05, weight_decay=0.0),
    lambda: topt.lion(0.01, weight_decay=0.0),
    lambda: topt.sgd(0.05, momentum=0.9),
], ids=["adamw", "lion", "sgd"])
def test_converges_on_quadratic(make):
    Q = torch.diag(torch.tensor([1.0, 5.0, 10.0]))
    opt = make()
    x = torch.ones(3)
    state = opt.init(x)
    for _ in range(300):
        upd, state = opt.update(Q @ x, state, x)
        x = topt.apply_updates(x, upd)
    assert float(0.5 * x @ Q @ x) < 1e-3


def test_adamw_weight_decay_shrinks():
    opt = topt.adamw(0.1, weight_decay=0.5)
    x = torch.ones(4)
    before = float(torch.linalg.norm(x))
    state = opt.init(x)
    upd, state = opt.update(torch.zeros(4), state, x)
    assert float(torch.linalg.norm(topt.apply_updates(x, upd))) < before


def test_state_tree_mirrors_params():
    cfg = configs.get("llama3-405b", smoke=True)
    params = init_params(cfg, device="cpu")
    st_ = topt.adamw(1e-3).init(params)
    assert pytree.tree_structure(st_.mu) == pytree.tree_structure(params)
    assert all(m.dtype == F32 for m in pytree.tree_leaves(st_.nu))


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), 20.0)
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0,
                               rtol=1e-6)


def test_schedules():
    s = topt.schedules.linear_warmup_cosine(1.0, 10, 100)
    assert float(s(torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(s(torch.tensor(10))), 1.0)
    assert float(s(torch.tensor(100))) < 0.2
    inv = topt.schedules.inverse_sqrt(1.0, 10)
    np.testing.assert_allclose(float(inv(torch.tensor(40))), 0.5)


def test_roundtrip_error_bounded():
    g = {"w": torch.randn(100, generator=torch.Generator().manual_seed(0))}
    want = g["w"].clone()
    err = tgc.init_error_state(g)
    out, _ = tgc.roundtrip(g, err)
    scale = float(want.abs().max()) / 127.0
    assert float((out["w"] - want).abs().max()) <= scale + 1e-6


def test_error_feedback_accumulates():
    w = 0.01 * torch.randn(50, generator=torch.Generator().manual_seed(0))
    err = tgc.init_error_state({"w": w})
    total_q = torch.zeros(50)
    for _ in range(50):
        out, err = tgc.roundtrip({"w": w.clone()}, err)
        total_q = total_q + out["w"]
    rel = float(torch.linalg.norm(total_q - 50 * w)
                / torch.linalg.norm(50 * w))
    assert rel < 0.02


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_property_compression_4x(seed):
    g = torch.randn(4096, generator=torch.Generator().manual_seed(seed))
    c = tgc._quantize(g)
    raw = g.numel() * 4
    comp = c.q.numel() * 1 + c.scale.numel() * 4
    assert comp * 3 < raw
