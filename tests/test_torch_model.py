"""The port's model (``forward``, ``decode_step``) against ``repro.models``.

The JAX package's parameters are carried across with
``interop.params_from_numpy``, so both packages run the same weights on
the same tokens.  Configs: ``qwen1.5-4b-smoke`` (MHA with QKV bias),
``llama3-405b-smoke`` (GQA 8/2), ``rwkv6-3b-smoke``,
``granite-moe-3b-a800m-smoke`` (GQA + MoE), ``deepseek-v2-236b-smoke``
(MLA + MoE with shared experts) and ``zamba2-7b-smoke`` (Mamba-2 trunk +
shared attention), plus the ``vlm`` / ``audio`` / squared-ReLU smoke
configs for ``forward``.

  * ``forward`` with ``use_kernel`` False and True (the JAX kernels in
    interpret mode), in float32 within 1e-4 and in bfloat16 within the
    reference's own bound for two bf16 paths of one model (atol 0.15, rtol
    0.1, ``tests/test_kernels.py:175``) and ‖Δ‖/‖ref‖ ≤ 3e-2.  The two
    packages round bfloat16 at the same points, but single elementwise ops
    round differently by one bf16 unit (XLA's logistic against PyTorch's
    sigmoid, for one), and over the layers that grows to 0.6–1.5 % of the
    logits' norm and, with the test suite's x64 mode on, up to 0.125 on
    one logit (``rwkv6-3b``; 0.0535 for ``llama3-405b``), so 5e-2
    elementwise does not hold for every config.  The MoE aux loss is held
    to the same limits as the logits.
  * ``moe_dispatch="sparse"`` (the gather dispatch) against the JAX
    package's, and a hybrid of 5 layers with ``SHARED_ATTN_EVERY`` set to
    2 in both packages (segments of 2, 2 and 1, the shared block after
    each), forward and decode.
  * ``decode_step`` token by token against the JAX ``decode_step`` (float32,
    1e-4), and against the port's own ``forward`` (float32 1e-4, bfloat16
    5e-2).
  * ``params_from_numpy`` on bfloat16 leaves and back, bit for bit (the
    float32 router, the stacked experts and the hybrid's unstacked
    ``shared_attn`` included).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jcfgs
from repro import models as JM
from torch.utils import _pytree as pytree

from repro.models import model as JMmodel
from repro_torch import configs, interop
from repro_torch import models as TM
from repro_torch.models import model as TMmodel
from repro_torch.runtime import make_decode_step, make_prefill_step

NEW_ARCHS = ["granite-moe-3b-a800m", "deepseek-v2-236b", "zamba2-7b"]
ARCHS = ["qwen1.5-4b", "llama3-405b", "rwkv6-3b"] + NEW_ARCHS


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


def _leaves(caches):
    """Cache leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(caches, dict):
        return [leaf for k in sorted(caches) for leaf in _leaves(caches[k])]
    return pytree.tree_leaves(caches)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _check_across(got, want, dtype, flipped=None):
    """The port's output against the JAX package's (see the docstring).
    ``flipped`` (B, S) marks tokens whose MoE top-k set differs between
    the packages in some layer: the bfloat16 elementwise bound leaves
    them out (a changed expert is a jump, not a rounding), the norm bound
    keeps them."""
    g, w = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        return
    assert np.linalg.norm(g - w) <= 3e-2 * np.linalg.norm(w)
    if flipped is not None:
        g, w = g[~flipped], w[~flipped]
    np.testing.assert_allclose(g, w, atol=0.15, rtol=0.1)


@pytest.fixture
def routing(monkeypatch):
    """Records, in both packages, every MoE layer's top-k set (gates > 0)
    per token; ``flipped()`` is the (B, S) mask of tokens whose set
    differs in some layer.  The JAX side records through an ordered
    ``jax.debug.callback``, so its layer scan runs compiled, as it does
    untested."""
    import repro.models.moe as jmoe
    import repro_torch.models.moe as tmoe
    sets = {"jax": [], "torch": []}

    def recording(module, key):
        real = module._router_probs

        def fn(params, m, x):
            gates, aux = real(params, m, x)
            if key == "jax":
                jax.debug.callback(
                    lambda g: sets[key].append(np.asarray(g)), gates > 0,
                    ordered=True)
            else:
                sets[key].append(np.asarray(gates > 0))
            return gates, aux
        monkeypatch.setattr(module, "_router_probs", fn)

    recording(jmoe, "jax")
    recording(tmoe, "torch")

    def flipped():
        assert len(sets["jax"]) == len(sets["torch"]) > 0
        return np.any([(a != b).any(-1) for a, b in
                       zip(sets["jax"], sets["torch"])], axis=0)
    return flipped


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
def test_forward_matches_jax(arch, dtype, use_kernel, jax_kernels_interpret,
                             routing):
    """For the MoE configs the tokens whose top-k set differs between the
    packages in some layer are counted: none in float32, at most 1/16 of
    them in bfloat16 (where the attention and the router input round
    differently), and those are left out of the elementwise bound."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    x = _inputs(tcfg, 2, 32)        # 32: the chunked WKV path off-kernel
    want, aux_j = JM.forward(jp, jcfg, jnp.asarray(x),
                             use_kernel=use_kernel, remat=False)
    jax.effects_barrier()
    got, aux_t = TM.forward(tp, tcfg, torch.from_numpy(x),
                            use_kernel=use_kernel)
    flipped = routing() if tcfg.moe else None
    assert got.shape == (2, 32, tcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    torch.testing.assert_close(make_prefill_step(
        tcfg, use_kernel=use_kernel)(tp, torch.from_numpy(x)), got,
        atol=0, rtol=0)
    if flipped is not None:
        assert flipped.sum() <= (0 if dtype == "float32" else
                                 flipped.size // 16), flipped.sum()
    _check_across(got, want, dtype, flipped)
    if tcfg.moe:             # the summed load-balancing loss, float32
        assert aux_t.dtype == torch.float32 and aux_t.ndim == 0
        _check_across(aux_t, aux_j, dtype)
    else:
        assert aux_t == 0.0 == float(aux_j)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b"])
def test_sparse_moe_dispatch_matches_jax(arch):
    """``moe_dispatch="sparse"``: the gather dispatch at capacity factor 2
    in every MoE layer, logits and aux in float32 within 1e-4."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _params(jcfg, tcfg, seed=2)
    x = _inputs(tcfg, 2, 32, seed=2)
    want, aux_j = JM.forward(jp, jcfg, jnp.asarray(x), remat=False,
                             moe_dispatch="sparse")
    got, aux_t = TM.forward(tp, tcfg, torch.from_numpy(x),
                            moe_dispatch="sparse")
    _check_across(got, want, "float32")
    _check_across(aux_t, aux_j, "float32")
    dense, _ = TM.forward(tp, tcfg, torch.from_numpy(x))
    assert not torch.allclose(got, dense, atol=1e-4)    # a dispatch apart


@pytest.fixture
def five_layer_hybrid(monkeypatch):
    """zamba2-7b-smoke at 5 layers with SHARED_ATTN_EVERY = 2 in both
    packages: segments of 2, 2 and 1 layers, the shared block after each
    (3 applications, 3 shared caches), in float32."""
    monkeypatch.setattr(JMmodel, "SHARED_ATTN_EVERY", 2)
    monkeypatch.setattr(TMmodel, "SHARED_ATTN_EVERY", 2)
    jcfg, tcfg = (dataclasses.replace(c, num_layers=5)
                  for c in _cfgs("zamba2-7b", "float32"))
    jp, tp = _params(jcfg, tcfg, seed=5)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_hybrid_segments_with_a_remainder(five_layer_hybrid, use_kernel,
                                          jax_kernels_interpret,
                                          monkeypatch):
    jcfg, tcfg, jp, tp = five_layer_hybrid
    calls = []
    shared = TMmodel._shared_attn_block
    monkeypatch.setattr(TMmodel, "_shared_attn_block",
                        lambda *a, **k: calls.append(1) or shared(*a, **k))
    x = _inputs(tcfg, 2, 16, seed=5)
    want, _ = JM.forward(jp, jcfg, jnp.asarray(x), use_kernel=use_kernel,
                         remat=False)
    got, _ = TM.forward(tp, tcfg, torch.from_numpy(x),
                        use_kernel=use_kernel)
    assert len(calls) == 3
    _check_across(got, want, "float32")
    # the cadence matters: at the default (one segment of 5) the logits
    # differ
    monkeypatch.setattr(TMmodel, "SHARED_ATTN_EVERY", 27)
    other, _ = TM.forward(tp, tcfg, torch.from_numpy(x))
    assert not torch.allclose(other, got, atol=1e-3)


def test_hybrid_decode_with_a_remainder_matches_jax(five_layer_hybrid):
    jcfg, tcfg, jp, tp = five_layer_hybrid
    B, S = 2, 6
    x = _inputs(tcfg, B, S, seed=6)
    js = JM.init_decode_state(jcfg, B, S + 2)
    ts = TM.init_decode_state(tcfg, B, S + 2, device="cpu")
    assert ts.caches["shared"][0].shape[0] == 3
    for t in range(S):
        jl, js = JM.decode_step(jp, jcfg, js, jnp.asarray(x[:, t:t + 1]))
        tl, ts = TM.decode_step(tp, tcfg, ts, torch.from_numpy(x[:, t:t + 1]))
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=1e-4)
    for tc, jc in zip(_leaves(ts.caches),
                      jax.tree_util.tree_leaves(js.caches)):
        np.testing.assert_allclose(_f32(tc), _f32(jc), atol=1e-4, rtol=1e-4)


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
        before = [c.clone() for c in pytree.tree_leaves(ts.caches)]
        tl, ts2 = step(tp, ts, torch.from_numpy(x[:, t:t + 1]))
        # the state passed in is left as it was
        assert all(torch.equal(a, b) for a, b in
                   zip(before, pytree.tree_leaves(ts.caches)))
        ts = ts2
        assert ts.index == int(js.index) == t + 1
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=1e-4)
        outs.append(tl[:, 0])
    leaves = _leaves(ts.caches)
    assert len(leaves) == len(jax.tree_util.tree_leaves(js.caches))
    for tc, jc in zip(leaves, jax.tree_util.tree_leaves(js.caches)):
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


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_round_trip_of_the_new_families(arch):
    """The float32 router of a bf16 MoE model, the stacked experts
    (L, E, d, f) and the hybrid's unstacked ``shared_attn`` cross both
    ways, every leaf keeping its type, bf16 bit for bit."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp = jax.tree_util.tree_map(np.asarray,
                                JM.init_params(jax.random.PRNGKey(3), jcfg))
    tp = interop.params_from_numpy(jp, tcfg, device="cpu")
    blk = tp["blocks"][0]
    if tcfg.moe:
        m = tcfg.moe
        assert blk["mlp"]["router"].dtype == torch.float32
        assert blk["mlp"]["w_up"].shape == (m.num_experts, tcfg.d_model,
                                            m.expert_d_ff)
        assert blk["mlp"]["w_up"].dtype == torch.bfloat16
    else:
        assert tp["shared_attn"]["attn"]["w_q"].shape == \
            jp["shared_attn"]["attn"]["w_q"].shape
        assert blk["mamba"]["A_log"].dtype == torch.float32
    back = interop.params_to_numpy(tp, bfloat16=jnp.bfloat16)
    flat_j, tree_j = jax.tree_util.tree_flatten(jp)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # a subtree too many or too few is refused
    with pytest.raises(ValueError, match="subtrees"):
        interop.params_from_numpy(dict(jp, extra={}), tcfg, device="cpu")
    if "shared_attn" in jp:
        short = {k: v for k, v in jp.items() if k != "shared_attn"}
        with pytest.raises(ValueError, match="subtrees"):
            interop.params_from_numpy(short, tcfg, device="cpu")


def test_entry_points_default_to_the_card_and_every_family_builds():
    cfg = configs.get("qwen1.5-4b", smoke=True)
    if not torch.cuda.is_available():
        for call in (lambda: TM.init_params(cfg),
                     lambda: TM.init_decode_state(cfg, 1, 4),
                     lambda: interop.params_from_numpy({}, cfg)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    with pytest.raises(ValueError, match="generator"):
        TM.init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    assert not hasattr(TMmodel, "check_supported")
    x = torch.zeros(1, 4, dtype=torch.int64)
    for arch in NEW_ARCHS:      # MoE, MLA and the hybrid build on the CPU
        c = configs.get(arch, smoke=True)
        p = TM.init_params(c, torch.Generator().manual_seed(0), device="cpu")
        logits, _ = TM.forward(p, c, x)
        state = TM.init_decode_state(c, 1, 4, device="cpu")
        step, _ = TM.decode_step(p, c, state, x[:, :1])
        assert logits.shape == (1, 4, c.vocab_size)
        assert step.shape == (1, 1, c.vocab_size)
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    # remat is ported (the training slice); the sharding constraints take
    # NamedShardings (their mesh runs: tests/test_torch_mesh_training.py)
    torch.testing.assert_close(TM.forward(tp, cfg, x, remat=True)[0],
                               TM.forward(tp, cfg, x, remat=False)[0],
                               atol=0, rtol=0)
    for kw in ({"act_sharding": object()}, {"sp_sharding": object()}):
        with pytest.raises(TypeError, match="NamedSharding"):
            TM.forward(tp, cfg, x, **kw)
    # a model without MoE ignores the dispatch, as the reference
    torch.testing.assert_close(TM.forward(tp, cfg, x,
                                          moe_dispatch="sparse")[0],
                               TM.forward(tp, cfg, x)[0], atol=0, rtol=0)
    hubert = configs.get("hubert-xlarge", smoke=True)
    hp = TM.init_params(hubert, torch.Generator().manual_seed(0),
                        device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        TM.decode_step(hp, hubert,
                       TM.init_decode_state(hubert, 1, 4, device="cpu"),
                       torch.zeros(1, 1, hubert.d_model))
