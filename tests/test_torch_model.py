"""The port's model (``forward``, ``decode_step``) against ``repro.models``.

The JAX package's parameters are carried across with
``interop.params_from_numpy``, so both packages run the same weights on
the same tokens.  Configs: ``qwen1.5-4b-smoke`` (MHA with QKV bias),
``llama3-405b-smoke`` (GQA 8/2) and ``rwkv6-3b-smoke``, plus the
``vlm`` / ``audio`` / squared-ReLU smoke configs for ``forward``.

  * ``forward`` with ``use_kernel`` False and True (the JAX kernels in
    interpret mode), in float32 within 1e-4 and in bfloat16 within the
    reference's own bound for two bf16 paths of one model (atol 0.15, rtol
    0.1, ``tests/test_kernels.py:175``) and ‖Δ‖/‖ref‖ ≤ 3e-2.  The two
    packages round bfloat16 at the same points, but single elementwise ops
    round differently by one bf16 unit (XLA's logistic against PyTorch's
    sigmoid, for one), and over the layers that grows to 0.6–1.5 % of the
    logits' norm and, with the test suite's x64 mode on, up to 0.125 on
    one logit (``rwkv6-3b``; 0.0535 for ``llama3-405b``), so 5e-2
    elementwise does not hold for every config.
  * ``decode_step`` token by token against the JAX ``decode_step`` (float32,
    1e-4), and against the port's own ``forward`` (float32 1e-4, bfloat16
    5e-2).
  * ``params_from_numpy`` on bfloat16 leaves and back, bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jcfgs
from repro import models as JM
from repro_torch import configs, interop
from repro_torch import models as TM
from repro_torch.runtime import make_decode_step, make_prefill_step

ARCHS = ["qwen1.5-4b", "llama3-405b", "rwkv6-3b"]


def _cfgs(arch, dtype):
    return (dataclasses.replace(jcfgs.get(arch, smoke=True), dtype=dtype),
            dataclasses.replace(configs.get(arch, smoke=True), dtype=dtype))


def _params(jcfg, tcfg, seed=0):
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jp, tp


def _inputs(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embedding_frontend == "stub_embeddings":
        return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _check_across(got, want, dtype):
    """The port's output against the JAX package's (see the docstring)."""
    g, w = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        return
    np.testing.assert_allclose(g, w, atol=0.15, rtol=0.1)
    assert np.linalg.norm(g - w) <= 3e-2 * np.linalg.norm(w)


@pytest.fixture
def jax_kernels_interpret(monkeypatch):
    """The JAX Pallas kernels in interpret mode, as tests/test_kernels.py
    runs ``forward(use_kernel=True)`` on the CPU."""
    import repro.kernels.flash_attention.ops as fa_ops
    import repro.kernels.rwkv_wkv.ops as wkv_ops
    fa, wkv = fa_ops.flash_attention, wkv_ops.wkv
    monkeypatch.setattr(fa_ops, "flash_attention",
                        lambda q, k, v, causal=True: fa(
                            q, k, v, causal=causal, interpret=True))
    monkeypatch.setattr(wkv_ops, "wkv",
                        lambda r, k, v, w, u, state0=None: wkv(
                            r, k, v, w, u, state0, interpret=True))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + ["qwen2-vl-72b", "hubert-xlarge",
                                          "nemotron-4-340b"])
def test_forward_matches_jax(arch, dtype, use_kernel, jax_kernels_interpret):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    x = _inputs(tcfg, 2, 32)        # 32: the chunked WKV path off-kernel
    want, _ = JM.forward(jp, jcfg, jnp.asarray(x), use_kernel=use_kernel,
                         remat=False)
    got = make_prefill_step(tcfg, use_kernel=use_kernel)(
        tp, torch.from_numpy(x))
    assert got.shape == (2, 32, tcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    _check_across(got, want, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_sequence_matches_jax_and_forward(arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _params(jcfg, tcfg, seed=1)
    B, S = 2, 8
    x = _inputs(tcfg, B, S, seed=1)
    js = JM.init_decode_state(jcfg, B, S + 4)
    ts = TM.init_decode_state(tcfg, B, S + 4, device="cpu")
    step = make_decode_step(tcfg)
    outs = []
    for t in range(S):
        jl, js = JM.decode_step(jp, jcfg, js, jnp.asarray(x[:, t:t + 1]))
        before = [c.clone() for c in ts.caches]
        tl, ts2 = step(tp, ts, torch.from_numpy(x[:, t:t + 1]))
        # the state passed in is left as it was
        assert all(torch.equal(a, b) for a, b in zip(before, ts.caches))
        ts = ts2
        assert ts.index == int(js.index) == t + 1
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=1e-4)
        outs.append(tl[:, 0])
    for tc, jc in zip(ts.caches, js.caches):
        np.testing.assert_allclose(_f32(tc), _f32(jc), atol=1e-4, rtol=1e-4)
    full, _ = TM.forward(tp, tcfg, torch.from_numpy(x))
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_matches_forward(arch):
    """The reference's decode-vs-forward check, on the port alone."""
    tcfg = configs.get(arch, smoke=True)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    x = torch.from_numpy(_inputs(tcfg, 2, 8, seed=2))
    full, _ = TM.forward(tp, tcfg, x)
    state = TM.init_decode_state(tcfg, 2, 12, device="cpu")
    outs = []
    for t in range(8):
        lg, state = TM.decode_step(tp, tcfg, state, x[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_f32(torch.stack(outs, 1)), _f32(full),
                               atol=5e-2, rtol=5e-2)


def test_params_round_trip_on_bf16_leaves():
    jcfg, tcfg = _cfgs("rwkv6-3b", "bfloat16")
    jp = jax.tree_util.tree_map(np.asarray,
                                JM.init_params(jax.random.PRNGKey(3), jcfg))
    tp = interop.params_from_numpy(jp, tcfg, device="cpu")
    assert tp["embed"]["tok"].dtype == torch.bfloat16
    assert tp["blocks"][0]["tm"]["bonus"].dtype == torch.float32
    assert tp["blocks"][0]["tm"]["decay_base"].dtype == torch.float32
    assert len(tp["blocks"]) == tcfg.num_layers
    back = interop.params_to_numpy(tp, bfloat16=jnp.bfloat16)
    widened = interop.params_to_numpy(tp)
    flat_j, tree_j = jax.tree_util.tree_flatten(jp)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for a, b, c in zip(flat_j, flat_b, jax.tree_util.tree_leaves(widened)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()                  # bit for bit
        np.testing.assert_array_equal(np.asarray(a, np.float32), c)
    # a port-made model runs in JAX through the same route
    tp2 = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    jp2 = jax.tree_util.tree_map(
        jnp.asarray, interop.params_to_numpy(tp2, bfloat16=jnp.bfloat16))
    x = _inputs(tcfg, 1, 8)
    want, _ = JM.forward(jp2, jcfg, jnp.asarray(x), remat=False)
    got, _ = TM.forward(tp2, tcfg, torch.from_numpy(x))
    _check_across(got, want, "bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = interop.params_to_numpy(tp, bfloat16=jnp.bfloat16)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(shapes)
    for a, s in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype
    n = sum(a.size for a in jax.tree_util.tree_leaves(got))
    assert abs(tcfg.param_count() - n) / n < 0.25


def test_entry_points_default_to_the_card_and_unported_families_raise():
    cfg = configs.get("qwen1.5-4b", smoke=True)
    if not torch.cuda.is_available():
        for call in (lambda: TM.init_params(cfg),
                     lambda: TM.init_decode_state(cfg, 1, 4),
                     lambda: interop.params_from_numpy({}, cfg)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    with pytest.raises(ValueError, match="generator"):
        TM.init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    for arch in ("granite-moe-3b-a800m", "deepseek-v2-236b", "zamba2-7b"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
            TM.init_params(configs.get(arch, smoke=True), device="cpu")
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros(1, 4, dtype=torch.int64)
    for kw in ({"remat": True}, {"act_sharding": object()},
               {"moe_dispatch": "sparse"}):
        with pytest.raises(NotImplementedError):
            TM.forward(tp, cfg, x, **kw)
    hubert = configs.get("hubert-xlarge", smoke=True)
    hp = TM.init_params(hubert, torch.Generator().manual_seed(0),
                        device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        TM.decode_step(hp, hubert,
                       TM.init_decode_state(hubert, 1, 4, device="cpu"),
                       torch.zeros(1, 1, hubert.d_model))
