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
from repro_torch.models import moe as TX

ARCHS = ["granite-moe-3b-a800m", "deepseek-v2-236b"]
DISPATCHES = ["moe_apply_dense", "moe_apply_sparse_gather",
              "moe_apply_sparse"]
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


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_jax(arch, dispatch):
    (jcfg, jp, xj), (tcfg, tp, xt) = _setup(arch)
    want, aux_j = getattr(JX, dispatch)(jp, jcfg, xj)
    got, aux_t = getattr(TX, dispatch)(tp, tcfg, xt)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    _close(got, want)
    _close(aux_t, aux_j)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_dispatch_in_bfloat16(arch):
    """bfloat16 against the JAX package within the reference's two-path
    bound (atol 0.15, rtol 0.1) and ‖Δ‖/‖ref‖ ≤ 3e-2; the aux loss (a
    float32 router) within 1e-5."""
    (jcfg, jp, xj), (tcfg, tp, xt) = _setup(arch, "bfloat16")
    want, aux_j = JX.moe_apply_dense(jp, jcfg, xj)
    got, aux_t = TX.moe_apply_dense(tp, tcfg, xt)
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
