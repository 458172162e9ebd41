"""One train step of every other model family on a 2 × 2 gloo mesh.

The families that ``tests/test_torch_mesh_training.py`` does not train
(the dense ``llama3-405b`` and ``qwen1.5-4b`` are there): the vlm and
audio stubs (``qwen2-vl-72b``, M-RoPE, and ``hubert-xlarge``, bidirectional,
both fed embeddings), the MoE with GQA (``granite-moe-3b-a800m``) and with
MLA (``deepseek-v2-236b``), the SSM (``rwkv6-3b``) and the hybrid
(``zamba2-7b``).  Each smoke config, in float32, takes one AdamW step on 4
ranks from the JAX package's initial state, placed by ``params_specs``
(two launches of 4 ranks at once, three families each; the ranks are
``python -c`` subprocesses in gloo groups, the pattern of
``tests/test_torch_distributed.py``).  Each step is held

  * to the port's own unmeshed step from the same state: the loss and the
    gradient norm within 1e-5 relative (the mesh changes only the order
    of float32 sums: partial products reduced over the model axis, shards
    of the norm);
  * to the JAX package's unmeshed jitted step, with ``check_step``'s
    tolerances, the gradient norm within 2e-5: the two legs above and in
    ``tests/test_torch_train_loop.py`` (unmeshed port against JAX, 1e-5)
    added.
"""
import jax
import numpy as np
import pytest

from repro import optim as jopt
from repro.runtime import train_loop as jtl
from repro_torch import interop
from repro_torch import optim as topt
from repro_torch.runtime import train_loop as ttl

from test_torch_mesh_training import (LR, NORM_RTOL, LOSS_RTOL, _batches,
                                      _cfgs, _rel, check_against_jax, launch)

FAMILIES = [("qwen2-vl-72b", "rwkv6-3b", "granite-moe-3b-a800m"),
            ("hubert-xlarge", "zamba2-7b", "deepseek-v2-236b")]
ARCHS = [a for group in FAMILIES for a in group]


def _start(arch, jo):
    jcfg, tcfg = _cfgs(arch)
    jstate = jax.jit(lambda k: jtl.make_train_state(jcfg, jo, k))(
        jax.random.PRNGKey(0))
    port = interop.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), tcfg, device="cpu")
    return jcfg, tcfg, jstate, port


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    jo = jopt.adamw(LR)
    starts, waits = {}, []
    for k, group in enumerate(FAMILIES):
        jobs = {}
        for arch in group:
            jcfg, tcfg, jstate, port = _start(arch, jo)
            batches = _batches(jcfg, 1)
            jobs[arch] = {"arch": arch, "replace": {"dtype": "float32"},
                          "lr": LR, "tcfg": dict(remat=False),
                          "states": [port], "batches": batches}
            starts[arch] = (jcfg, tcfg, jstate, batches)
        waits.append(launch(tmp_path_factory.mktemp(f"families{k}"),
                            {"mesh": (2, 2), "train": jobs}, world=4))
    trajectories, plain = {}, {}
    for arch, (jcfg, tcfg, jstate, batches) in starts.items():
        jstep = jax.jit(jtl.make_train_step(
            jcfg, jo, jtl.TrainStepConfig(remat=False)))
        (x, y), = batches
        after, jm = jstep(jstate, x, y)
        trajectories[arch] = [(jstate, after, jm)]
        state = interop.train_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate), tcfg, device="cpu")
        _, tm = ttl.make_train_step(tcfg, topt.adamw(LR), ttl.TrainStepConfig(
            remat=False))(state, x, y)
        plain[arch] = {k: float(v) for k, v in tm.items()}
    res = {}
    for wait in waits:
        res.update(wait())
    return res, trajectories, plain


@pytest.mark.parametrize("arch", ARCHS)
def test_family_step_on_2x2_matches_the_unmeshed_steps(families, arch):
    res, trajectories, plain = families
    assert len(res[arch]) == 1
    (tm, _), = res[arch]
    assert _rel(tm["loss"], plain[arch]["loss"]) <= LOSS_RTOL
    assert _rel(tm["grad_norm"], plain[arch]["grad_norm"]) <= NORM_RTOL
    check_against_jax(res[arch], trajectories[arch],
                      norm_rtol=2 * NORM_RTOL)
