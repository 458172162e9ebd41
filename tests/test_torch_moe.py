"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe``.

The same numpy router, expert stacks and tokens go through both packages,
for ``granite-moe-3b-a800m-smoke`` (8 experts, top-2, no shared experts)
and ``deepseek-v2-236b-smoke`` (8 routed experts, top-2, 2 shared):

  * ``moe_init``'s tree, shapes and types (the router float32 in a
    bfloat16 model, the experts stacked (E, d, f));
  * ``_router_probs``: the renormalised top-k gates and the Switch aux
    loss;
  * the three dispatches (dense, sparse by gather / scatter-add, sparse
    by one-hot products), float32 within 1e-5, and dense in bfloat16
    within the two-path bound of ``tests/test_torch_model.py``;
  * dropless dispatch, which the JAX package lacks, against its dense
    dispatch in the same way, and against the port's dense dispatch where
    some expert gets no token and where a gate is exactly 0: float32
    within 1e-5, the aux loss bit for bit, the k·N rows it computes
    counted;
  * ``_dense_block`` keeps dense dispatch on the CPU, under autograd, on
    a DTensor and below ``DROPLESS_MIN_WASTE_FLOP``, and takes dropless
    dispatch only on the card without autograd (a tensor that reports
    ``is_cuda`` stands in for the card); where the rule puts the published
    widths;
  * the sparse dispatches equal dense where every expert's capacity holds
    its tokens, and equal the JAX package's (dropped tokens included)
    where it does not.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jcfgs
from repro.models import moe as JX
from repro_torch import configs
from repro_torch.interop import _leaf_to_tensor
from repro_torch.models import model as mdl
from repro_torch.models import moe as TX
from repro_torch.observability import metrics

ARCHS = ["granite-moe-3b-a800m", "deepseek-v2-236b"]
DISPATCHES = ["moe_apply_dense", "moe_apply_sparse_gather",
              "moe_apply_sparse"]
# the JAX package's dispatch each of the port's is held to, where the
# names differ (it has no dropless form: the same function as dense)
JAX_DISPATCH = {"moe_apply_dropless": "moe_apply_dense"}
ATOL = 1e-5


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jcfgs.get(arch, smoke=True), dtype=dtype),
            dataclasses.replace(configs.get(arch, smoke=True), dtype=dtype))


def _setup(arch, dtype="float32", B=2, S=16, seed=0):
    """JAX parameters from ``moe_init``, the same numbers as tensors, and
    tokens (B, S, d) from numpy."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = jax.tree_util.tree_map(np.asarray,
                                JX.moe_init(jax.random.PRNGKey(seed), jcfg))
    tp = jax.tree_util.tree_map(lambda a: _leaf_to_tensor(a, "cpu"), jp)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    return (jcfg, jp, xj), (tcfg, tp, xt)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_tree_shapes_and_types(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp = JX.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = TX.moe_init(torch.Generator().manual_seed(0), tcfg, device="cpu")

    def sig(tree):
        return {k: sig(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    assert sig(tp) == sig(jp)
    m = tcfg.moe
    assert tp["router"].dtype == torch.float32
    assert tp["w_gate"].shape == (m.num_experts, tcfg.d_model,
                                  m.expert_d_ff)
    assert ("shared" in tp) == bool(m.num_shared_experts)
    # standard normal × 1/√fan-in, as the reference
    w = tp["w_down"].float()
    assert abs(float(w.std()) * m.expert_d_ff ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_match_jax(arch):
    (jcfg, jp, xj), (tcfg, tp, xt) = _setup(arch, S=24)
    gj, aj = JX._router_probs(jp, jcfg.moe, xj)
    gt, at = TX._router_probs(tp, tcfg.moe, xt)
    _close(gt, gj)
    _close(at, aj)
    # top-k of E, renormalised
    assert ((gt > 0).sum(-1) == tcfg.moe.top_k).all()
    torch.testing.assert_close(gt.sum(-1), torch.ones(gt.shape[:-1]))


@pytest.mark.parametrize("dispatch", DISPATCHES + ["moe_apply_dropless"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_jax(arch, dispatch):
    (jcfg, jp, xj), (tcfg, tp, xt) = _setup(arch)
    want, aux_j = getattr(JX, JAX_DISPATCH.get(dispatch, dispatch))(
        jp, jcfg, xj)
    got, aux_t = getattr(TX, dispatch)(tp, tcfg, xt)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    _close(got, want)
    _close(aux_t, aux_j)


@pytest.mark.parametrize(
    "arch,dispatch",
    [(a, "moe_apply_dense") for a in ARCHS]
    + [(a, "moe_apply_dropless") for a in ARCHS],
    ids=ARCHS + [f"{a}-dropless" for a in ARCHS])
def test_dense_dispatch_in_bfloat16(arch, dispatch):
    """Dense and dropless dispatch in bfloat16 against the JAX package's
    dense dispatch within the reference's two-path bound (atol 0.15, rtol
    0.1) and ‖Δ‖/‖ref‖ ≤ 3e-2; the aux loss (a float32 router) within
    1e-5."""
    (jcfg, jp, xj), (tcfg, tp, xt) = _setup(arch, "bfloat16")
    want, aux_j = JX.moe_apply_dense(jp, jcfg, xj)
    got, aux_t = getattr(TX, dispatch)(tp, tcfg, xt)
    assert got.dtype == torch.bfloat16
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, atol=0.15, rtol=0.1)
    assert np.linalg.norm(g - w) <= 3e-2 * np.linalg.norm(w)
    _close(aux_t, aux_j)


@pytest.mark.parametrize("dispatch", DISPATCHES[1:])
@pytest.mark.parametrize("arch", ARCHS)
def test_sparse_equals_dense_where_capacity_suffices(arch, dispatch):
    """capacity_factor E/k gives every expert room for all N tokens."""
    (_, _, _), (tcfg, tp, xt) = _setup(arch, S=24)
    m = tcfg.moe
    dense, aux_d = TX.moe_apply_dense(tp, tcfg, xt)
    got, aux = getattr(TX, dispatch)(tp, tcfg, xt,
                                     capacity_factor=m.num_experts / m.top_k)
    _close(got, dense)
    assert float(aux) == float(aux_d)


@pytest.mark.parametrize("dispatch", DISPATCHES[1:])
@pytest.mark.parametrize("arch", ARCHS)
def test_sparse_drops_tokens_as_jax_does(arch, dispatch):
    """capacity_factor 0.5: the later tokens of a busy expert are dropped,
    the same ones in both packages."""
    (jcfg, jp, xj), (tcfg, tp, xt) = _setup(arch, S=24)
    want, _ = getattr(JX, dispatch)(jp, jcfg, xj, capacity_factor=0.5)
    got, _ = getattr(TX, dispatch)(tp, tcfg, xt, capacity_factor=0.5)
    _close(got, want)
    dense, _ = TX.moe_apply_dense(tp, tcfg, xt)
    dropped = (got - dense).abs().amax(-1) > 1e-3        # per token
    assert 0 < int(dropped.sum()) < dropped.numel()


def _rows_counted():
    values = metrics.global_registry().snapshot().get(
        "moe_expert_rows_total", {"values": {}})["values"]
    return (values.get('kind="computed"', 0.0),
            values.get('kind="routed"', 0.0))


@pytest.mark.parametrize("case", ["every expert", "an expert without tokens",
                                  "a gate at 0"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dropless_equals_dense(arch, case, monkeypatch):
    """Dropless dispatch against the port's dense dispatch in float32
    (1e-5), the aux loss bit for bit, and the rows it computes counted
    under a profiler: k·N, a pair whose gate is exactly 0 run as a padding
    row of gate 0.  Two tokens reach at most 2k of the 8 experts; the
    zeroed gate is token 0's largest, so that token has k - 1 pairs."""
    B, S = (1, 2) if case == "an expert without tokens" else (2, 16)
    (_, _, _), (tcfg, tp, xt) = _setup(arch, B=B, S=S)
    m = tcfg.moe
    real = TX._router_probs
    if case == "a gate at 0":
        def router(params, moe_cfg, x):
            gates, aux = real(params, moe_cfg, x)
            g = gates.reshape(-1, gates.shape[-1])
            g[0, g[0].argmax()] = 0.0
            return gates, aux
        monkeypatch.setattr(TX, "_router_probs", router)
    gates, _ = TX._router_probs(tp, m, xt)
    pairs = int((gates > 0).sum())
    if case == "an expert without tokens":
        assert int(((gates > 0).reshape(-1, m.num_experts).sum(0) == 0)
                   .sum()) >= m.num_experts - 2 * m.top_k
    dense, aux_d = TX.moe_apply_dense(tp, tcfg, xt)
    before = _rows_counted()
    with torch.profiler.profile():
        got, aux = TX.moe_apply_dropless(tp, tcfg, xt)
    computed, routed = (a - b for a, b in zip(_rows_counted(), before))
    assert got.shape == xt.shape and got.dtype == xt.dtype
    _close(got, dense)
    assert torch.equal(aux, aux_d)
    N = B * S
    assert routed == m.top_k * N
    assert computed == m.top_k * N
    assert pairs == m.top_k * N - (case == "a gate at 0")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``, as one on the card does; the
    operations of ``_dense_block`` keep the subclass."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case", ["cpu", "autograd", "dtensor", "card",
                                  "card, too few tokens"])
def test_dense_block_takes_dropless_only_on_the_card_without_autograd(
        case, monkeypatch):
    """``_dense_block`` runs dense dispatch on the CPU, with autograd on, on
    a DTensor (``is_dtensor`` answering yes for the stand-in) and where
    dense dispatch's wasted products fall short of
    ``DROPLESS_MIN_WASTE_FLOP`` (set here to the smoke size's waste, and
    one FLOP above it), and dropless dispatch on the card without autograd;
    both give its output within 1e-5 in float32."""
    _, tcfg = _cfgs("granite-moe-3b-a800m")
    params = mdl.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    bp = params["blocks"][0]
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32))
    m = tcfg.moe
    waste = 6 * (m.num_experts - m.top_k) * h.numel() * m.expert_d_ff
    monkeypatch.setattr(mdl, "DROPLESS_MIN_WASTE_FLOP",
                        waste + (case == "card, too few tokens"))
    want, _ = mdl._dense_block(bp, tcfg, h, False, True)
    if case != "cpu":
        h = h.as_subclass(_OnCard)
    if case == "dtensor":
        monkeypatch.setattr(mdl, "is_dtensor", lambda t: True)
    called = []
    for name in ("moe_apply_dense", "moe_apply_dropless"):
        def wrapped(*args, _real=getattr(TX, name), _name=name):
            called.append(_name)
            return _real(*args)
        monkeypatch.setattr(TX, name, wrapped)
    with torch.set_grad_enabled(case == "autograd"):
        got, _ = mdl._dense_block(bp, tcfg, h, False, True)
    assert called == ["moe_apply_dropless" if case == "card"
                      else "moe_apply_dense"]
    _close(got.as_subclass(torch.Tensor), want.numpy())


@pytest.mark.parametrize("arch,B,S,dropless", [
    ("granite-moe-3b-a800m", 1, 2048, False),
    ("granite-moe-3b-a800m", 4, 2048, True),
    ("granite-moe-3b-a800m", 128, 2048, True),
    ("deepseek-v2-236b", 1, 2048, True),
    ("deepseek-v2-236b", 1, 64, False)])
def test_the_dropless_rule_at_published_widths(arch, B, S, dropless):
    """Where the forward on the card takes dropless dispatch at the
    published widths: granite's 2,048-token prompt alone stays dense, four
    of them (``chip_smoke.py``'s prefill) and the benchmark's 128 go
    dropless, as does one prompt of deepseek-v2's 160 experts; a handful of
    its tokens stays dense."""
    cfg = configs.get(arch)
    x = torch.empty(B, S, cfg.d_model, device="meta").as_subclass(_OnCard)
    with torch.no_grad():
        assert mdl._dropless(x, cfg) is dropless
