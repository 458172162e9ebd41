"""The port's train step against ``repro.runtime.make_train_step``.

Each step starts from the same numpy state in both packages (the JAX
package's state after the previous step, carried across with
``interop.train_state_from_numpy``), so rounding does not compound over
the steps, and the JAX step runs jitted.  In float32, on the smoke configs
of six families (``qwen1.5-4b``, ``llama3-405b``,
``granite-moe-3b-a800m``, ``deepseek-v2-236b``, ``rwkv6-3b``,
``zamba2-7b``), over 3 AdamW steps at lr 1e-3:

  * the loss within 1e-5 relative and ``grad_norm`` within 1e-5 relative;
  * the parameters after each step within 1e-6, at every entry whose
    gradient the two packages compute alike to 1e-3 (read from the first
    moment: ``(μ_new − b1·μ_old) / (1 − b1)`` is the step's gradient).
    AdamW divides each gradient entry by its own magnitude, so an entry at
    float32 rounding noise (|g| ≈ 1e-8 where the leaf's are ≈ 1e-2: the
    packages sum in other orders) takes an update of unrelated size in
    each package: those entries, at most 2 % of a model's, are held to
    the most two AdamW updates can differ, 2·lr.

In bfloat16 on ``qwen1.5-4b`` the step is held to the bound
``tests/test_torch_model.py`` uses for two bf16 paths (atol 0.15, rtol 0.1
and ‖Δ‖/‖ref‖ ≤ 3e-2).  Microbatched steps are held to the reference's
microbatched step and the port's own full-batch gradient;
and ``compress_grads=True`` to the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import configs as jcfgs
from repro import optim as jopt
from repro.runtime import train_loop as jtl
from repro_torch import configs, interop
from repro_torch import optim as topt
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.runtime import train_loop as ttl

ARCHS = ["qwen1.5-4b", "llama3-405b", "granite-moe-3b-a800m",
         "deepseek-v2-236b", "rwkv6-3b", "zamba2-7b"]
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-5
PARAM_ATOL = 1e-6
NOISE = 1e-3          # gradients agreeing to less than this are noise
NOISE_SHARE = 0.02


def leaves_by_path(tree):
    """{key path: numpy leaf} of a JAX-layout tree (bfloat16 as float32,
    exactly)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        a = np.asarray(leaf)
        out[jax.tree_util.keystr(path)] = a.astype(np.float32) \
            if a.dtype.name == "bfloat16" else a
    return out


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def check_step(jstep, tstep, jstate, tstate, batch, mu_b1, lr,
               dtype="float32"):
    """One step of each package from equal states (see the module
    docstring); returns the JAX state after it."""
    x, y = batch
    mu0 = leaves_by_path(jstate.opt_state.mu)
    jstate, jm = jstep(jstate, x, y)
    tstate2, tm = tstep(tstate, x, y)
    assert tstate2.params is tstate.params          # updated in place
    assert int(tm["step"]) == int(jm["step"])
    got = leaves_by_path(interop.train_state_to_numpy(tstate2))
    want = leaves_by_path(jstate)
    assert got.keys() == want.keys()
    if dtype == "bfloat16":
        for a, b in ((tm["loss"], jm["loss"]),
                     (tm["grad_norm"], jm["grad_norm"])):
            np.testing.assert_allclose(float(a), float(b), atol=0.15,
                                       rtol=0.1)
            assert _rel(a, b) <= 3e-2
        for key in (k for k in want if k.startswith(".params")):
            np.testing.assert_allclose(got[key], want[key], atol=0.15,
                                       rtol=0.1, err_msg=key)
            # and each entry within two updates and one bf16 rounding
            assert np.all(np.abs(got[key] - want[key])
                          <= 2 * lr + 2.0 ** -7 * np.abs(want[key])), key
        return jstate
    assert _rel(tm["loss"], jm["loss"]) <= LOSS_RTOL
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= NORM_RTOL
    noisy = total = 0
    for key in (k for k in want if k.startswith(".params")):
        mu = key.replace(".params", ".opt_state.mu", 1)
        g = np.abs(want[mu] - mu_b1 * mu0[mu[len(".opt_state.mu"):]]) \
            / (1 - mu_b1)
        dg = np.abs(want[mu] - got[mu]) / (1 - mu_b1)
        noise = dg > NOISE * g
        d = np.abs(got[key] - want[key])
        assert d[~noise].max(initial=0) <= PARAM_ATOL, key
        assert d[noise].max(initial=0) <= 2 * lr, key
        noisy += int(noise.sum())
        total += noise.size
    assert noisy <= NOISE_SHARE * total, (noisy, total)
    return jstate


def _setup(arch, dtype="float32", seq=16, batch=4):
    jcfg = dataclasses.replace(jcfgs.get(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(configs.get(arch, smoke=True), dtype=dtype)
    stream = SyntheticLMStream(DataConfig(vocab_size=jcfg.vocab_size,
                                          seq_len=seq, global_batch=batch))
    return jcfg, tcfg, stream


def jax_state(jcfg, jo, seed=0, compress=False):
    """The JAX package's ``make_train_state``, jitted (one compile in
    place of the eager initializers')."""
    return jax.jit(lambda k: jtl.make_train_state(jcfg, jo, k, compress))(
        jax.random.PRNGKey(seed))


def _steps(arch, dtype, steps=3, lr=1e-3, **tkw):
    jcfg, tcfg, stream = _setup(arch, dtype)
    jo, to = jopt.adamw(lr), topt.adamw(lr)
    jstep = jax.jit(jtl.make_train_step(
        jcfg, jo, jtl.TrainStepConfig(remat=False, **tkw)))
    tstep = ttl.make_train_step(tcfg, to, ttl.TrainStepConfig(**tkw))
    jstate = jax_state(jcfg, jo,
                       compress=tkw.get("compress_grads", False))
    for k in range(steps):
        tstate = interop.train_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate), tcfg, device="cpu")
        jstate = check_step(jstep, tstep, jstate, tstate, stream.batch_at(k),
                            mu_b1=0.9, lr=lr, dtype=dtype)
    return jstate


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    _steps(arch, "float32")


def test_bf16_train_step_matches_jax():
    _steps("qwen1.5-4b", "bfloat16")


def test_microbatched_step_matches_jax():
    _steps("llama3-405b", "float32", steps=2, microbatches=2)


def test_microbatched_gradient_equals_the_full_batch():
    _, tcfg, stream = _setup("llama3-405b", batch=8)
    params = interop.params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_state(_setup("llama3-405b")[0],
                              jopt.adamw(1e-3)).params), tcfg, "cpu")
    x, y = (torch.as_tensor(a) for a in stream.batch_at(0))
    full = ttl.make_value_and_grad(tcfg, ttl.TrainStepConfig(remat=False))
    loss1, g1 = full(params, x, y)
    for mb in (2, 4):
        micro = ttl.make_value_and_grad(tcfg, ttl.TrainStepConfig(
            remat=False, microbatches=mb))
        loss, g = micro(params, x, y)
        assert _rel(loss, loss1) <= 1e-6
        for a, b in zip(pytree.tree_leaves(g), pytree.tree_leaves(g1)):
            assert a.dtype == torch.float32
            assert float(torch.linalg.norm(a - b)) <= \
                1e-5 * float(torch.linalg.norm(b))
    with pytest.raises(ValueError, match="microbatches"):
        ttl.make_value_and_grad(tcfg, ttl.TrainStepConfig(
            microbatches=3))(params, x, y)


def test_compress_grads_matches_jax():
    jstate = _steps("qwen1.5-4b", "float32", steps=2, compress_grads=True)
    assert jstate.err_state is not None
