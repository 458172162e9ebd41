"""DeepSeek-V2 as the benchmark runs it, on the CPU, and its MLA kernel.

CPU (float32, seeded random weights from the port's ``init_params``):

  * The port's forward against the plain reference
    ``portbench/reference/mla_moe.py`` (loaded by path: it imports nothing
    of the port), within 1e-5 of ‖ref‖, at a smoke size, one case for each
    of DeepSeek-V2's mechanisms on top of a plain MoE configuration:
    group-limited routing, ×16 weights without renormalisation, the dense
    layer 0, YaRN, the held share of the routed experts, and all of them.
    Each case's logits differ from the plain configuration's, so no case
    passes by leaving its mechanism out.
  * The share (expert parallelism's cut): the routed parts that 8 shares of
    the experts give under the port's dense and dropless dispatch, with the
    shared experts counted once, add up to the uncut reference's MoE layer.
  * ``kernels/mla_attention``'s plain path against the model's MLA formula
    (``models/layers._mla_core``), with q_nope a strided view as the model
    passes it; on CPU tensors the op never launches.
  * The sparse dispatches refuse a share; decode step by step through the
    latent cache agrees with the prefill under every mechanism.

Card (``cuda`` marker; skipped without a CUDA device): the Hopper kernel
against the plain version at (1, 8,192) and ragged lengths, with q_nope a
strided view of the up-projected query and the one rope key of every head
read in place; what it refuses::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_deepseek_v2.py
"""
import ctypes
import dataclasses
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.mla_attention import kernel as mla_kernel
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.models import layers as L
from repro_torch.models import model as mdl
from repro_torch.models import moe as X

REPO = Path(__file__).resolve().parents[1]


def _reference():
    path = REPO / "portbench" / "reference" / "mla_moe.py"
    spec = importlib.util.spec_from_file_location("mla_moe_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()

# a plain MoE configuration with MLA at a smoke size; each case turns one
# of DeepSeek-V2's mechanisms on (the configuration file's sizes, cut)
PLAIN = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
             q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=32,
             qk_rope_head_dim=16, v_head_dim=32, intermediate_size=96,
             moe_intermediate_size=32, router_experts=16,
             n_routed_experts=16, first_held_expert=0, n_shared_experts=2,
             num_experts_per_tok=3, n_group=1, topk_group=1,
             norm_topk_prob=True, routed_scaling_factor=1.0,
             first_k_dense_replace=0, rms_norm_eps=1e-6, rope_theta=10000.0,
             vocab_size=512,
             rope_scaling=dict(factor=1.0, original_max_position_embeddings=16,
                               beta_fast=32, beta_slow=1, mscale=1.0,
                               mscale_all_dim=0.0))
YARN = dict(factor=40.0, original_max_position_embeddings=16, beta_fast=32,
            beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
CASES = {
    "group-limited routing": dict(n_group=4, topk_group=2),
    "x16 without renormalisation": dict(norm_topk_prob=False,
                                        routed_scaling_factor=16.0),
    "dense layer 0": dict(first_k_dense_replace=1),
    "yarn": dict(rope_scaling=YARN),
    "held share": dict(n_routed_experts=4, first_held_expert=8),
    "all": dict(n_group=4, topk_group=2, norm_topk_prob=False,
                routed_scaling_factor=16.0, first_k_dense_replace=1,
                rope_scaling=YARN, n_routed_experts=4, first_held_expert=8),
}


def _port_config(c, dtype="float32"):
    """The port's config of the reference's sizes ``c``."""
    y = c["rope_scaling"]
    base = configs.get("deepseek-v2-236b", smoke=True)
    moe = dataclasses.replace(
        base.moe, num_experts=c["router_experts"],
        num_shared_experts=c["n_shared_experts"],
        top_k=c["num_experts_per_tok"],
        expert_d_ff=c["moe_intermediate_size"], n_group=c["n_group"],
        topk_group=c["topk_group"], norm_topk_prob=c["norm_topk_prob"],
        routed_scaling_factor=c["routed_scaling_factor"],
        first_held=c["first_held_expert"], num_held=c["n_routed_experts"])
    return dataclasses.replace(
        base, num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_attention_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], kv_lora_rank=c["kv_lora_rank"],
        q_lora_rank=c["q_lora_rank"],
        qk_rope_head_dim=c["qk_rope_head_dim"],
        qk_nope_head_dim=c["qk_nope_head_dim"], v_head_dim=c["v_head_dim"],
        norm_eps=c["rms_norm_eps"], rope_theta=c["rope_theta"],
        moe_layer_start=c["first_k_dense_replace"], moe=moe,
        yarn_factor=y["factor"],
        yarn_original_max_position=y["original_max_position_embeddings"],
        yarn_beta_fast=y["beta_fast"], yarn_beta_slow=y["beta_slow"],
        yarn_mscale=y["mscale"], yarn_mscale_all_dim=y["mscale_all_dim"],
        dtype=dtype)


def _tokens(c, batch=2, seq=40, seed=1):
    return torch.randint(0, c["vocab_size"], (batch, seq),
                         generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _prefill(c, seed=0, tokens=None):
    cfg = _port_config(c)
    params = mdl.init_params(cfg, torch.Generator().manual_seed(seed),
                             device="cpu")
    tokens = _tokens(c) if tokens is None else tokens
    with torch.no_grad():
        logits, _ = mdl.forward(params, cfg, tokens, use_kernel=True,
                                remat=False)
    return cfg, params, tokens, logits


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_the_plain_reference(case):
    c = {**PLAIN, **CASES[case]}
    _, params, tokens, got = _prefill(c)
    with torch.no_grad():
        want = REF.forward(params, c, tokens)
    assert _rel(got, want) < 1e-5
    _, _, _, plain = _prefill(PLAIN, tokens=tokens)
    if case != "held share":          # other stacks: other weights
        assert _rel(got, plain) > 1e-3


def test_the_shares_add_up_to_the_uncut_layer():
    """8 shares of 2 experts each, as 8 devices would hold them: their
    routed parts plus the shared experts, once, are the uncut layer (the
    reference's, every expert held), under dense and dropless dispatch."""
    c = {**PLAIN, **CASES["all"], "n_routed_experts": 16,
         "first_held_expert": 0}
    cfg = _port_config(c)
    params = mdl.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    layer = params["blocks"][1]["mlp"]
    x = torch.randn(2, 24, c["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = REF.moe(layer, c, x.reshape(-1, c["hidden_size"]),
                       REF.exact_mm).view(x.shape)
        shared = X._shared(layer, x)
        for dispatch in (X.moe_apply_dense, X.moe_apply_dropless):
            total = shared.clone()
            for i in range(8):
                part = dataclasses.replace(
                    cfg, moe=dataclasses.replace(cfg.moe, first_held=2 * i,
                                                 num_held=2))
                held = {**layer, **{w: layer[w][2 * i:2 * i + 2]
                                    for w in ("w_gate", "w_up", "w_down")}}
                out, _ = dispatch(held, part, x)
                total += out - shared
            assert _rel(total, want) < 1e-5, dispatch.__name__


def test_a_share_holds_only_its_experts_stacks():
    c = {**PLAIN, **CASES["held share"]}
    cfg = _port_config(c)
    p = mdl.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")["blocks"][0]["mlp"]
    assert cfg.moe.held == (8, 12) and cfg.moe.is_share
    assert p["router"].shape == (c["hidden_size"], 16)
    assert p["w_gate"].shape[0] == p["w_down"].shape[0] == 4
    assert not _port_config(PLAIN).moe.is_share


@pytest.mark.parametrize("dispatch", ["moe_apply_sparse_gather",
                                      "moe_apply_sparse"])
def test_the_sparse_dispatches_refuse_a_share(dispatch):
    c = {**PLAIN, **CASES["held share"]}
    cfg = _port_config(c)
    p = mdl.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")["blocks"][0]["mlp"]
    with pytest.raises(NotImplementedError, match="dense or dropless"):
        getattr(X, dispatch)(p, cfg, torch.zeros(1, 4, c["hidden_size"]))


def test_decode_through_the_latent_cache_matches_the_prefill():
    c = {**PLAIN, **CASES["all"]}
    cfg, params, tokens, want = _prefill(c, tokens=_tokens(c, seq=24))
    state = mdl.init_decode_state(cfg, tokens.shape[0], 32, device="cpu")
    got = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            logits, state = mdl.decode_step(params, cfg, state,
                                            tokens[:, t:t + 1])
            got.append(logits)
    assert _rel(torch.cat(got, dim=1), want) < 1e-5


def _mla_inputs(B, S, H, dn=128, dr=64, dv=128, dtype=torch.float32,
                device="cpu", seed=0):
    """q_nope as the model passes it (a view of the (B, S, H, dr + dn)
    query, the rope columns first), q_rope, k_nope, k_rope (B, S, dr), v."""
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)
    q = r(B, S, H, dr + dn)
    return q[..., dr:], r(B, S, H, dr), r(B, S, H, dn), r(B, S, dr), \
        r(B, S, H, dv)


@pytest.mark.parametrize("B,S,H,dn,dr,dv", [(2, 33, 3, 8, 4, 5),
                                            (1, 64, 2, 32, 16, 32),
                                            (2, 7, 4, 128, 64, 128)],
                         ids=str)
def test_the_mla_ops_plain_path_is_the_models_formula(B, S, H, dn, dr, dv):
    qn, qr, kn, kr, v = _mla_inputs(B, S, H, dn, dr, dv)
    scale = 0.37
    before = mla_ops.LAUNCHES
    got = mla_ops.mla_attention(qn, qr, kn, kr, v, scale=scale)
    mask = torch.arange(S)[None, :] <= torch.arange(S)[:, None]
    want = L._mla_core(qn, qr, kn, kr, v, scale, mask)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert mla_ops.LAUNCHES == before
    assert mla_ops.LAUNCHES_BY_ROUTE == {"tc": mla_ops.LAUNCHES}


def test_the_kernel_route_takes_deepseeks_widths_only():
    qn, qr, kn, kr, v = _mla_inputs(1, 8, 2, dtype=torch.bfloat16)
    assert mla_kernel.supported(qn, qr, kn, kr, v) is None
    assert "bfloat16" in mla_kernel.supported(
        *(t.float() for t in (qn, qr, kn, kr, v)))
    small = _mla_inputs(1, 8, 2, 32, 16, 32, dtype=torch.bfloat16)
    assert "widths" in mla_kernel.supported(*small)
    with pytest.raises(ValueError, match="agree"):
        mla_kernel.dims(qn, qr, kn[:, :4], kr, v)
    with pytest.raises(ValueError, match="same S positions"):
        mla_kernel.dims(qn, qr, kn[:, :4], kr[:, :4], v[:, :4])


def test_the_binding_declares_the_c_interfaces_parameters():
    """``kernel._ARGTYPES`` lists one type for each parameter of the C
    function it binds, in the source's order of pointers, ints, stride
    arrays, the float scale and the stream."""
    src = (Path(mla_kernel.__file__).parent / "csrc"
           / "mla_attention.cu").read_text()
    params = re.search(r"int mla_attention_tc_bf16\(([^)]*)\)",
                       src).group(1).split(",")
    kinds = [re.sub(r"\s*\b\w+$", "", p.strip()) for p in params]
    want = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "const long long*": ctypes.POINTER(ctypes.c_longlong)}
    assert [want[k] for k in kinds] == mla_kernel._ARGTYPES


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with `pytest -m cuda` on the "
                    "card)")
    return torch.device("cuda")


def _limit(want):
    """One bf16 rounding of the output (2⁻⁷ of the value) plus 1e-4 of the
    largest |output| (sums in another order), as the flash-attention
    kernel's bf16 limit."""
    big = float(want.float().abs().max())
    return 2.0 ** -7 * want.float().abs() + 1e-4 * big


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H", [(1, 8192, 2), (2, 1000, 3), (1, 129, 4),
                                   (3, 77, 5), (1, 1, 1), (2, 2048, 8)],
                         ids=str)
def test_mla_kernel_matches_plain_on_card(cuda_device, B, S, H):
    ts = _mla_inputs(B, S, H, dtype=torch.bfloat16, device=cuda_device,
                     seed=S)
    scale = L.yarn_get_mscale(40.0, 0.707) ** 2 / 192 ** 0.5
    before = mla_ops.LAUNCHES
    got = mla_ops.mla_attention(*ts, scale=scale)
    torch.cuda.synchronize()
    assert mla_ops.LAUNCHES == before + 1
    want = mla_ops.mla_attention_ref(*ts, scale=scale)
    assert got.shape == want.shape == (B, S, H, 128)
    assert ts[0]._base is not None          # q_nope: a view of the query
    err = (got.float() - want.float()).abs()
    assert bool((err <= _limit(want)).all()), float(err.max())


@pytest.mark.cuda
def test_mla_kernel_rejects_what_it_does_not_take(cuda_device):
    qn, qr, kn, kr, v = _mla_inputs(1, 16, 2, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        mla_ops.mla_attention(qn, qr, kn, kr, v)
    small = _mla_inputs(1, 16, 2, 32, 16, 32, dtype=torch.bfloat16,
                        device=cuda_device)
    with pytest.raises(ValueError, match="widths"):
        mla_ops.mla_attention(*small)
