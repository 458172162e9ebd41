"""Elastic restart of the port's training on a smaller mesh.

The counterpart of ``tests/test_elastic.py``: ``qwen1.5-4b`` smoke (bf16,
SGD at lr 1e-2 without momentum, remat off, batches of 8 × 16 from the
deterministic ``SyntheticLMStream``) trains 6 steps on 8 gloo ranks
(a 4 × 2 mesh), checkpoints, and "loses" half the fleet: 4 ranks (2 × 2)
restore the checkpoint, each rank reading its own shards, and train 4
more.  An uninterrupted 10-step run on 2 × 2 is the control, as there.
Every run starts from the JAX package's initial state (carried across with
``interop``), and the JAX package's unmeshed jitted step runs the same 10
steps here, in the test process, while the ranks run:

  * the restored run's 4 losses within 5e-2 of the uninterrupted run's
    (the reference's bf16 limit; the uninterrupted run one step off breaks
    it), and both runs' losses within 5e-2 of the JAX trajectory's;
  * the checkpoint written on the 4 × 2 mesh (full arrays, one writer)
    loads in the JAX package's ``CheckpointManager``, and 4 JAX steps from
    it give losses within 5e-2 of the restored port run's.

The ranks are ``python -c`` subprocesses in gloo groups over a file store
with a 60 s group timeout and a timeout per child (the pattern of
``tests/test_torch_distributed.py``).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro import optim as jopt
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import DataConfig, SyntheticLMStream
from repro.runtime import train_loop as jtl
from repro_torch import configs as tcfgs
from repro_torch import interop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60
CHILD_TIMEOUT_S = 300        # the ranks share the host with the other tests
LIMIT = 5e-2          # the reference's own limit (bf16)
ARCH, LR, SEQ, BATCH = "qwen1.5-4b", 1e-2, 16, 8

PHASE = textwrap.dedent("""
    import datetime, json, sys
    import torch
    import torch.distributed as dist

    (rank, world, init, state_file, mesh_shape, start, steps,
     ckpt) = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
              tuple(int(v) for v in sys.argv[5].split("x")),
              int(sys.argv[6]), int(sys.argv[7]), sys.argv[8])
    dist.init_process_group(
        "gloo", init_method="file://" + init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=%(timeout)d))
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizer import OptState
    from repro_torch.runtime import (TrainState, TrainStepConfig,
                                     make_train_step)

    cfg = configs.get("%(arch)s", smoke=True)
    step = make_train_step(cfg, sgd(%(lr)r, momentum=0.0),
                           TrainStepConfig(remat=False))
    mesh = make_host_mesh(*mesh_shape, device="cpu")
    state = torch.load(state_file, weights_only=False)
    ps = shd.params_specs(state.params, shd.ShardingRules(), mesh)
    state = shd.distribute(state, mesh, TrainState(
        params=ps, opt_state=OptState(step=None, mu=ps, nu=None),
        err_state=None))
    mgr = CheckpointManager(ckpt)
    latest = mgr.latest_step()
    if latest is not None:
        assert latest == start, (latest, start)
        state = mgr.restore(latest, state)      # each rank its own shards
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=%(seq)d,
                                          global_batch=%(batch)d))
    losses = []
    for s in range(start, start + steps):
        x, y = stream.batch_at(s)
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
    mgr.save(start + steps, state, blocking=True)
    if rank == 0:
        print("LOSSES", json.dumps(losses))
    dist.destroy_process_group()
""") % {"timeout": GROUP_TIMEOUT_S, "arch": ARCH, "lr": LR, "seq": SEQ,
        "batch": BATCH}


def start_phase(tmp, name, mesh, start, steps, ckpt, state_file):
    d, m = (int(v) for v in mesh.split("x"))
    world = d * m
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", PHASE, str(r), str(world),
         str(tmp / f"group_{name}"), str(state_file), mesh, str(start),
         str(steps), str(ckpt)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]

    def wait():
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=CHILD_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-4000:]
        return json.loads(outs[0][0].split("LOSSES", 1)[1])
    return wait


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    jcfg, tcfg = jcfgs.get(ARCH, smoke=True), tcfgs.get(ARCH, smoke=True)
    jo = jopt.sgd(LR, momentum=0.0)
    jstate0 = jax.jit(lambda k: jtl.make_train_state(jcfg, jo, k))(
        jax.random.PRNGKey(0))
    state_file = tmp / "state0.pt"
    torch.save(interop.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate0), tcfg, device="cpu"),
        state_file)
    ckpt, ckpt_ref = tmp / "ckpt", tmp / "ckpt_ref"
    wait_8 = start_phase(tmp, "a", "4x2", 0, 6, ckpt, state_file)
    wait_ref = start_phase(tmp, "ref", "2x2", 0, 10, ckpt_ref, state_file)
    # the JAX package's unmeshed trajectory, while the ranks run
    jstep = jax.jit(jtl.make_train_step(jcfg, jo, jtl.TrainStepConfig(
        remat=False)))
    stream = SyntheticLMStream(DataConfig(vocab_size=jcfg.vocab_size,
                                          seq_len=SEQ, global_batch=BATCH))
    jstate, jax_losses = jstate0, []
    for s in range(10):
        jstate, m = jstep(jstate, *stream.batch_at(s))
        jax_losses.append(float(m["loss"]))
    first = wait_8()
    # the port's checkpoint of the 4 x 2 mesh, read by the JAX package
    target = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate0)
    jmgr = JCheckpointManager(str(ckpt))
    assert jmgr.latest_step() == 6
    restored = jmgr.restore(6, target)
    wait_4 = start_phase(tmp, "b", "2x2", 6, 4, ckpt, state_file)
    from_ckpt = []
    for s in range(6, 10):
        restored, m = jstep(restored, *stream.batch_at(s))
        from_ckpt.append(float(m["loss"]))
    return dict(first=first, second=wait_4(), reference=wait_ref(),
                jax=jax_losses, jax_from_ckpt=from_ckpt)


def test_restore_on_half_the_fleet_continues_the_trajectory(runs):
    second, ref = runs["second"], runs["reference"][6:]
    assert len(second) == len(ref) == 4
    for a, b in zip(second, ref):
        assert abs(a - b) < LIMIT, (second, ref)
    # the control: the trajectory one step off breaks the limit
    shifted = runs["reference"][5:9]
    assert max(abs(a - b) for a, b in zip(second, shifted)) > LIMIT, \
        (second, shifted)


def test_meshed_runs_follow_the_jax_trajectory(runs):
    jax_losses = runs["jax"]
    assert len(runs["first"]) == 6 and len(runs["reference"]) == 10
    for a, b in zip(runs["first"] + runs["second"], jax_losses):
        assert abs(a - b) < LIMIT, (runs["first"] + runs["second"],
                                    jax_losses)
    for a, b in zip(runs["reference"], jax_losses):
        assert abs(a - b) < LIMIT, (runs["reference"], jax_losses)


def test_mesh_checkpoint_loads_in_the_reference(runs):
    for a, b in zip(runs["jax_from_ckpt"], runs["second"]):
        assert abs(a - b) < LIMIT, (runs["jax_from_ckpt"], runs["second"])
