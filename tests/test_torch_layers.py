"""The port's shared model layers against ``repro.models.layers``.

Every ported layer function on the same numpy inputs and parameters in
both packages, in float32, within 1e-5: the norms, RoPE and M-RoPE, the
three MLP activations (GELU in its tanh form, as ``jax.nn.gelu``), GQA
attention for prefill (with and without QKV bias, causal and not, through
``_sdpa`` and through the flash-attention op against the JAX kernel in
interpret mode) and for decode against a cache (one token, and a chunk of
three that the length-only mask leaves non-causal in both packages), MLA
(DeepSeek-V2's latent attention, on the low-rank and the plain query
path) for prefill and for decode against its latent cache, the
embeddings.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jcfgs
from repro.models import layers as JL
from repro_torch import configs
from repro_torch.models import layers as TL

ATOL = 1e-5


def _cfg(name):
    """The smoke config in float32 from both packages."""
    return (dataclasses.replace(jcfgs.get(name, smoke=True), dtype="float32"),
            dataclasses.replace(configs.get(name, smoke=True),
                                dtype="float32"))


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(tree):
    """numpy pytree -> (jax tree, torch tree)."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                   tree))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=atol)


def _reference_fields(t, j):
    """asdict of the port's config ``t`` over the fields of the reference's
    ``j``; the port's own fields (YaRN, group-limited routing, the expert
    share) must hold their defaults, which keep the reference's
    behaviour."""
    if not dataclasses.is_dataclass(t):
        return t
    own = {f.name: f for f in dataclasses.fields(t)}
    ref = {f.name for f in dataclasses.fields(j)}
    for name in own.keys() - ref:
        assert getattr(t, name) == own[name].default, (type(t), name)
    return {name: _reference_fields(getattr(t, name), getattr(j, name))
            for name in ref}


def test_configs_are_the_reference_configs():
    assert configs.names() == jcfgs.names()
    assert configs.ALIASES == jcfgs.ALIASES
    for name in configs.names():
        for smoke in (False, True):
            t, j = configs.get(name, smoke), jcfgs.get(name, smoke)
            assert _reference_fields(t, j) == dataclasses.asdict(j)
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()


def test_norms():
    rng = np.random.default_rng(0)
    x = _np(rng, 2, 5, 16, scale=3.0)
    p = {"scale": _np(rng, 16), "bias": _np(rng, 16)}
    (xj, pj), (xt, pt) = _both((x, p))
    _close(TL.rmsnorm(pt, xt, 1e-5), JL.rmsnorm(pj, xj, 1e-5))
    _close(TL.layernorm(pt, xt, 1e-5), JL.layernorm(pj, xj, 1e-5))


def test_rope_and_mrope():
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 5, 3, 16)
    pos = rng.integers(0, 50, size=(2, 5))
    pos3 = rng.integers(0, 50, size=(3, 2, 5))
    (xj, pj, p3j), (xt, pt, p3t) = _both((x, pos, pos3))
    cj, sj = JL.rope_freqs(16, 10000.0, pj)
    ct, st = TL.rope_freqs(16, 10000.0, pt)
    _close(ct, cj)
    _close(st, sj)
    _close(TL.apply_rope(xt, ct, st), JL.apply_rope(xj, cj, sj))
    _close(TL.apply_mrope(xt, p3t, 1e6), JL.apply_mrope(xj, p3j, 1e6))
    _close(TL.apply_mrope(xt, p3t, 1e6, sections=(2, 3, 3)),
           JL.apply_mrope(xj, p3j, 1e6, sections=(2, 3, 3)))
    np.testing.assert_array_equal(TL.mrope_positions(2, 5).numpy(),
                                  np.asarray(JL.mrope_positions(2, 5)))


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
def test_mlp(activation):
    rng = np.random.default_rng(2)
    x = _np(rng, 2, 4, 16)
    p = {"w_up": _np(rng, 16, 24), "w_down": _np(rng, 24, 16)}
    if activation == "silu":
        p["w_gate"] = _np(rng, 16, 24)
    (xj, pj), (xt, pt) = _both((x, p))
    _close(TL.mlp_apply(pt, xt, activation), JL.mlp_apply(pj, xj, activation))
    with pytest.raises(ValueError):
        TL.mlp_apply(pt, xt, "tanh")


def _attn_params(cfg, rng):
    hd, d = cfg.resolved_head_dim, cfg.d_model
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    p = {"w_q": _np(rng, d, H * hd, scale=d ** -0.5),
         "w_k": _np(rng, d, Hkv * hd, scale=d ** -0.5),
         "w_v": _np(rng, d, Hkv * hd, scale=d ** -0.5),
         "w_o": _np(rng, H * hd, d, scale=(H * hd) ** -0.5)}
    if cfg.qkv_bias:
        p.update(b_q=_np(rng, H * hd, scale=0.1),
                 b_k=_np(rng, Hkv * hd, scale=0.1),
                 b_v=_np(rng, Hkv * hd, scale=0.1))
    return p


@pytest.fixture
def jax_flash_interpret(monkeypatch):
    """Run the JAX flash-attention op in interpret mode on the CPU, as
    ``tests/test_kernels.py`` does for ``use_kernel=True``."""
    import repro.kernels.flash_attention.ops as fa_ops
    orig = fa_ops.flash_attention
    monkeypatch.setattr(fa_ops, "flash_attention",
                        lambda q, k, v, causal=True: orig(
                            q, k, v, causal=causal, interpret=True))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["sdpa", "kernel"])
@pytest.mark.parametrize("arch", [
    "llama3-405b",                          # GQA 8/2
    "qwen1.5-4b",                           # MHA with QKV bias
    "hubert-xlarge",                        # non-causal encoder
    "qwen2-vl-72b",                         # M-RoPE
])
def test_attention_prefill(arch, use_kernel, jax_flash_interpret):
    jcfg, tcfg = _cfg(arch)
    rng = np.random.default_rng(3)
    x = _np(rng, 2, 16, tcfg.d_model)
    (xj, pj), (xt, pt) = _both((x, _attn_params(tcfg, rng)))
    want, none_j = JL.attention_apply(pj, jcfg, xj, use_kernel=use_kernel)
    got, none_t = TL.attention_apply(pt, tcfg, xt, use_kernel=use_kernel)
    assert none_j is None and none_t is None
    _close(got, want)


def test_sdpa_offset_and_decode_sdpa():
    rng = np.random.default_rng(4)
    q, k, v = _np(rng, 2, 3, 4, 8), _np(rng, 2, 7, 2, 8), _np(rng, 2, 7, 2, 8)
    (qj, kj, vj), (qt, kt, vt) = _both((q, k, v))
    # Sq = 3 against Sk = 7: the top-left mask (the reference's q_offset 0)
    _close(TL._sdpa(qt, kt, vt, True), JL._sdpa(qj, kj, vj, True))
    _close(TL._decode_sdpa(qt, kt, vt, 5), JL._decode_sdpa(qj, kj, vj, 5))


@pytest.mark.parametrize("S,index", [(1, 0), (1, 5), (3, 2)])
def test_attention_decode_with_cache(S, index):
    """One token, and a chunk of three: the length mask (keys < index + S)
    is not causal within the chunk, in both packages."""
    jcfg, tcfg = _cfg("llama3-405b")
    rng = np.random.default_rng(5)
    Smax = 12
    x = _np(rng, 2, S, tcfg.d_model)
    cache = (_np(rng, 2, Smax, tcfg.num_kv_heads, tcfg.resolved_head_dim),
             _np(rng, 2, Smax, tcfg.num_kv_heads, tcfg.resolved_head_dim))
    p = _attn_params(tcfg, rng)
    (xj, pj, cj), (xt, pt, ct) = _both((x, p, cache))
    want, (wk, wv) = JL.attention_apply(pj, jcfg, xj, kv_cache=cj,
                                        cache_index=jnp.int32(index))
    got, (gk, gv) = TL.attention_apply(pt, tcfg, xt, kv_cache=ct,
                                       cache_index=index)
    assert gk is ct[0] and gv is ct[1]          # written in place
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_scatter_cache_clamps_like_dynamic_update_slice():
    rng = np.random.default_rng(6)
    cache, new = _np(rng, 1, 6, 1, 2), _np(rng, 1, 3, 1, 2)
    (cj, nj), (ct, nt) = _both((cache, new))
    for index in (0, 2, 5):
        want = JL._scatter_cache(cj, nj, jnp.int32(index))
        got = TL._scatter_cache(ct.clone(), nt, index)
        _close(got, want, atol=0)


def _mla_cfg(q_lora):
    """deepseek-v2-236b's smoke config in float32, with the low-rank query
    path (q_lora_rank 48) or the plain ``w_q`` one (q_lora_rank 0)."""
    return tuple(dataclasses.replace(c, q_lora_rank=48 if q_lora else 0)
                 for c in _cfg("deepseek-v2-236b"))


def _mla_params(cfg, rng):
    d, H, r_kv = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dr, dn, dv = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
    qk = H * (dr + dn)
    p = {"w_dkv": _np(rng, d, r_kv + dr, scale=d ** -0.5),
         "kv_norm": {"scale": 1 + _np(rng, r_kv, scale=0.1)},
         "w_uk": _np(rng, r_kv, H * dn, scale=r_kv ** -0.5),
         "w_uv": _np(rng, r_kv, H * dv, scale=r_kv ** -0.5),
         "w_o": _np(rng, H * dv, d, scale=(H * dv) ** -0.5)}
    if cfg.q_lora_rank:
        r_q = cfg.q_lora_rank
        p.update(w_dq=_np(rng, d, r_q, scale=d ** -0.5),
                 q_norm={"scale": 1 + _np(rng, r_q, scale=0.1)},
                 w_uq=_np(rng, r_q, qk, scale=r_q ** -0.5))
    else:
        p["w_q"] = _np(rng, d, qk, scale=d ** -0.5)
    return p


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "w_q"])
def test_mla_prefill(q_lora):
    jcfg, tcfg = _mla_cfg(q_lora)
    rng = np.random.default_rng(8)
    x = _np(rng, 2, 16, tcfg.d_model)
    p = _mla_params(tcfg, rng)
    assert ("w_dq" in p) == q_lora and ("w_q" in p) != q_lora
    (xj, pj), (xt, pt) = _both((x, p))
    want, none_j = JL.mla_apply(pj, jcfg, xj)
    got, none_t = TL.mla_apply(pt, tcfg, xt)
    assert none_j is None and none_t is None
    assert got.shape == (2, 16, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("S,index", [(1, 0), (1, 5), (3, 2), (2, 11)])
@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "w_q"])
def test_mla_decode_with_cache(q_lora, S, index):
    """The latent cache (B, Smax, r_kv) and the rope-key cache (B, Smax,
    dr) are written at ``index`` in place (clamped at the end, as
    ``lax.dynamic_update_slice``: (2, 11) writes rows 10-11); one token,
    and chunks that the length mask leaves non-causal in both packages."""
    jcfg, tcfg = _mla_cfg(q_lora)
    rng = np.random.default_rng(9)
    Smax = 12
    x = _np(rng, 2, S, tcfg.d_model)
    cache = (_np(rng, 2, Smax, tcfg.kv_lora_rank),
             _np(rng, 2, Smax, tcfg.qk_rope_head_dim))
    (xj, pj, cj), (xt, pt, ct) = _both((x, _mla_params(tcfg, rng), cache))
    want, (wl, wr) = JL.mla_apply(pj, jcfg, xj, kv_cache=cj,
                                  cache_index=jnp.int32(index))
    got, (gl, gr) = TL.mla_apply(pt, tcfg, xt, kv_cache=ct,
                                 cache_index=index)
    assert gl is ct[0] and gr is ct[1]          # written in place
    _close(got, want)
    _close(gl, wl)
    _close(gr, wr)


def _signature(tree):
    """{name: (shape, dtype name)} of a nested dict of arrays or tensors."""
    return {k: _signature(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


def test_mla_init_and_cache_shapes():
    for q_lora in (True, False):
        jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                      for c in _mla_cfg(q_lora))
        jp = JL.mla_init(jax.random.PRNGKey(0), jcfg)
        tp = TL.mla_init(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
        assert _signature(tp) == _signature(jp)
        assert ("w_dq" in tp) == q_lora
    want = JL.make_mla_cache(jcfg, 2, 8)
    got = TL.make_mla_cache(tcfg, 2, 8, device="cpu")
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert all(t.dtype == torch.bfloat16 and not t.any() for t in got)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_embeddings(tied):
    rng = np.random.default_rng(7)
    p = {"tok": _np(rng, 32, 8)}
    if not tied:
        p["unembed"] = _np(rng, 8, 32)
    toks = rng.integers(0, 32, size=(2, 5)).astype(np.int32)
    x = _np(rng, 2, 5, 8)
    (pj, tj, xj), (pt, tt, xt) = _both((p, toks, x))
    _close(TL.embed(pt, tt), JL.embed(pj, tj), atol=0)
    _close(TL.unembed(pt, xt), JL.unembed(pj, xj))


def test_init_shapes_dtypes_and_distributions():
    tcfg = configs.get("qwen1.5-4b", smoke=True)
    jp = JL.attention_init(jax.random.PRNGKey(0), jcfgs.get("qwen1.5-4b",
                                                            smoke=True))
    gen = torch.Generator().manual_seed(0)
    tp = TL.attention_init(gen, tcfg, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tp.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jp.items()}
    w = torch.cat([TL.dense_init(gen, 256, 256, torch.float32, "cpu")
                   for _ in range(4)])
    assert abs(float(w.std()) * 16 - 1) < 0.02
    e = TL.embedding_init(gen, tcfg, device="cpu")
    assert abs(float(e["tok"].float().std()) / 0.02 - 1) < 0.05
    k, v = TL.make_kv_cache(tcfg, 2, 8, device="cpu")
    assert k.shape == (2, 8, 4, 16) and k.dtype == torch.bfloat16
    if not torch.cuda.is_available():          # the default is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TL.make_kv_cache(tcfg, 2, 8)
