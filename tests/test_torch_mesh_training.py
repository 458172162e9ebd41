"""Training on a mesh in the port, against the JAX package's unmeshed step.

Each rank is a ``python -c`` subprocess that imports only ``torch``, numpy
and ``repro_torch``, in a gloo group over a file store under ``tmp_path``
with a 60 s group timeout and a timeout per child; the JAX package runs in
the test process, unmeshed and jitted, on the same state (its own state
carried across with ``interop.train_state_from_numpy``) and batches.  The
reference's meshed runs cannot be the yardstick: on JAX 0.9
``jax.make_mesh`` makes Explicit axes, and the reference's vocab-sharded
embedding gather fails there (ROADMAP C); a mesh must not change the
mathematics, so the unmeshed step is what the meshed one is held to.

  * (i) ``llama3-405b`` smoke on 4 × 2 (8 ranks), one AdamW step (the
    counterpart of ``tests/test_distributed.py``'s sharded train step),
    held to ``check_step``'s tolerances (``tests/test_torch_train_loop.py``:
    the loss and the gradient norm within 1e-5 relative, each parameter
    within 1e-6 where the two packages' gradients agree to 1e-3, the noise
    entries within 2·lr);
  * (ii) ``qwen1.5-4b`` smoke on 2 × 2 with 2 microbatches, all four mesh
    options (``microbatch_sharding``, ``act_sharding``, ``sp_sharding``,
    ``grad_sharding``) and ``compress_grads``, 2 steps, held the same way
    against the reference's microbatched, compressed step;
  * (iv) the meshed forward with ``act_sharding`` and ``sp_sharding``
    against the JAX forward (``qwen1.5-4b`` and ``rwkv6-3b`` smoke), and
    the meshed prefill with ``use_kernel=True`` (the ops' plain versions
    on each rank's heads) against it: atol = rtol = 1e-4, as
    ``tests/test_torch_model.py`` holds the port's forward;
  * (v) a meshed decode (``llama3-405b`` smoke, caches placed by
    ``decode_state_specs``, batch over ``data``; and at batch 1 with the
    cache sequence-sharded) against the JAX package's unmeshed decode,
    logits of 6 tokens within the same limit;
  * (vi) ``grad_compression.roundtrip`` on DTensor leaves split so that no
    shard is a run of the leaf's flat order (a (48, 100) leaf split over
    its dim 1 and over both dims, a (4100,) vector split at 2050) equal bit
    for bit to the reference's roundtrip of the whole leaves, the
    reconstruction and the residual; the control, each shard compressed in
    its own chunks, differs.

``tests/test_torch_mesh_families.py`` holds one step of every other
family on 2 × 2.
"""
import dataclasses
import itertools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro import optim as jopt
from repro.models import model as jmdl
from repro.optim import grad_compression as jgc
from repro.runtime import train_loop as jtl
from repro_torch import configs as tcfgs
from repro_torch import interop
from repro_torch.data import DataConfig, SyntheticLMStream

from test_torch_train_loop import (LOSS_RTOL, NOISE, NOISE_SHARE, NORM_RTOL,
                                   PARAM_ATOL, _rel, leaves_by_path)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60
CHILD_TIMEOUT_S = 300        # the ranks share the host with the other tests
LR, MU_B1 = 1e-3, 0.9
FWD_TOL = 1e-4
SEQ, BATCH = 16, 8

# every rank runs this: torch, numpy and repro_torch only
CHILD = textwrap.dedent("""
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    rank, world, init, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group(
        "gloo", init_method="file://" + init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=%(timeout)d))
    from repro_torch import configs, interop
    from repro_torch._dtensor import constrain
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.spec import NamedSharding, P
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw
    from repro_torch.optim import grad_compression as gc
    from repro_torch.optim.optimizer import OptState
    from repro_torch.runtime import train_loop as tl

    jobs = torch.load(inp, weights_only=False)
    mesh = make_host_mesh(*jobs["mesh"], device="cpu")
    rules = shd.ShardingRules()
    NS = lambda spec: NamedSharding(mesh, spec)
    res = {}

    def cfg_of(job):
        import dataclasses
        return dataclasses.replace(configs.get(job["arch"], smoke=True),
                                   **job.get("replace", {}))

    def placed_state(state, compress):
        ps = shd.params_specs(state.params, rules, mesh)
        return shd.distribute(state, mesh, tl.TrainState(
            params=ps, opt_state=OptState(step=None, mu=ps, nu=ps),
            err_state=ps if compress else None)), ps

    for name, job in jobs["train"].items():
        cfg = cfg_of(job)
        ps = shd.params_specs(job["states"][0].params, rules, mesh)
        extra = {}
        if job.get("mesh_options"):
            extra = dict(
                microbatch_sharding=NS(P(None, "data")),
                act_sharding=NS(P("data", None, None)),
                sp_sharding=NS(P("data", "model", None)),
                grad_sharding=pytree.tree_map(
                    NS, ps, is_leaf=lambda x: isinstance(x, P)))
        step = tl.make_train_step(cfg, adamw(job["lr"]),
                                  tl.TrainStepConfig(**job["tcfg"], **extra))
        runs = []
        for start, (x, y) in zip(job["states"], job["batches"]):
            state, _ = placed_state(start, job["tcfg"].get(
                "compress_grads", False))
            state, m = step(state, x, y)
            runs.append(({k: float(v) for k, v in m.items()},
                         interop.train_state_to_numpy(state)))
        res[name] = runs

    for name, job in jobs.get("forward", {}).items():
        cfg = cfg_of(job)
        params = shd.distribute(job["params"], mesh, shd.params_specs(
            job["params"], rules, mesh))
        x = constrain(job["inputs"], NS(P("data")))
        with torch.no_grad():
            logits, _ = mdl.forward(
                params, cfg, x, remat=False,
                act_sharding=NS(P("data", None, None)),
                sp_sharding=NS(P("data", "model", None)))
            kernel = tl.make_prefill_step(
                cfg, use_kernel=True,
                act_sharding=NS(P("data", None, None)))(params, x)
        res[name] = (logits.full_tensor().numpy(),
                     kernel.full_tensor().numpy())

    for name, job in jobs.get("decode", {}).items():
        cfg = cfg_of(job)
        params = shd.distribute(job["params"], mesh, shd.params_specs(
            job["params"], rules, mesh))
        toks = job["tokens"]
        seq_shard = toks.shape[0] == 1
        st = mdl.init_decode_state(cfg, toks.shape[0], job["max_len"],
                                   device="cpu")
        st = mdl.DecodeState(caches=shd.distribute(
            st.caches, mesh, shd.decode_state_specs(
                st.caches, rules, cfg, mesh, seq_shard=seq_shard)), index=0)
        tok_sh = NS(P() if seq_shard else shd.batch_spec(rules))
        outs = []
        with torch.no_grad():
            for t in range(toks.shape[1]):
                lg, st = mdl.decode_step(params, cfg, st, constrain(
                    toks[:, t:t + 1], tok_sh))
                outs.append(lg.full_tensor().numpy())
        res[name] = np.concatenate(outs, axis=1)

    for name, job in jobs.get("compress", {}).items():
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch._dtensor import shard
        places = [Shard(d) if d is not None else Replicate()
                  for d in job["shard_dims"]]
        g = shard(job["g"].clone(), mesh, places)
        e = shard(job["e"].clone(), mesh, places)
        assert not all(p == Replicate() for p in g.placements)
        gc.roundtrip([g], [e])
        res["compress/" + name] = (g.full_tensor().numpy(),
                                   e.full_tensor().numpy())

    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()
    print("OK", rank)
""") % {"timeout": GROUP_TIMEOUT_S}


def launch(tmp, jobs, world):
    """Start ``world`` ranks on ``jobs``; returns a function that waits for
    them and gives rank 0's results."""
    torch.save(jobs, tmp / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(world), str(tmp / "group"),
         str(tmp / "inputs.pt"), str(tmp / "out.pt")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]

    def wait():
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=CHILD_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        for p, (o, e) in zip(procs, outs):
            assert p.returncode == 0, e[-4000:]
        return torch.load(tmp / "out.pt", weights_only=False)
    return wait


def _cfgs(arch):
    return (dataclasses.replace(jcfgs.get(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(tcfgs.get(arch, smoke=True),
                                dtype="float32"))


def _batches(cfg, steps, seed=0):
    """``steps`` batches: token ids from the data stream, or embeddings
    and labels drawn from ``seed`` for a stub frontend."""
    if cfg.embedding_frontend == "stub_embeddings":
        npr = np.random.RandomState(seed)
        return [(npr.randn(BATCH, SEQ, cfg.d_model).astype(np.float32),
                 npr.randint(0, cfg.vocab_size, (BATCH, SEQ)).astype(
                     np.int32)) for _ in range(steps)]
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=BATCH))
    return [stream.batch_at(k) for k in range(steps)]


def train_job(arch, steps=2, mesh_options=False, **tkw):
    """(port job, JAX trajectory).  The JAX package takes ``steps`` jitted
    steps; the port starts each of its steps from the JAX state before
    it, as ``check_step`` does (AdamW turns noise-level gradient
    differences into updates of up to lr, which would compound)."""
    jcfg, tcfg = _cfgs(arch)
    jo = jopt.adamw(LR)
    compress = tkw.get("compress_grads", False)
    jstate = jax.jit(lambda k: jtl.make_train_state(jcfg, jo, k, compress))(
        jax.random.PRNGKey(0))
    jstep = jax.jit(jtl.make_train_step(
        jcfg, jo, jtl.TrainStepConfig(remat=False, **tkw)))
    batches = _batches(jcfg, steps)
    trajectory = []           # (state before, state after, metrics)
    for x, y in batches:
        after, jm = jstep(jstate, x, y)
        trajectory.append((jstate, after, jm))
        jstate = after
    job = {"arch": arch, "replace": {"dtype": "float32"}, "lr": LR,
           "states": [interop.train_state_from_numpy(
               jax.tree_util.tree_map(np.asarray, before), tcfg,
               device="cpu") for before, _, _ in trajectory],
           "tcfg": dict(remat=True, **tkw), "mesh_options": mesh_options,
           "batches": batches}
    return job, trajectory


def check_against_jax(runs, trajectory, norm_rtol=NORM_RTOL):
    """Each meshed step (its metrics and its state, gathered) against the
    JAX step from the same state: ``check_step``'s tolerances (the
    gradient norm's ``norm_rtol``)."""
    assert len(runs) == len(trajectory)
    for (tm, got_state), (before, jstate, jm) in zip(runs, trajectory):
        mu0 = leaves_by_path(before.opt_state.mu)
        assert int(tm["step"]) == int(jm["step"])
        assert _rel(tm["loss"], jm["loss"]) <= LOSS_RTOL
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= norm_rtol
        got, want = leaves_by_path(got_state), leaves_by_path(jstate)
        assert got.keys() == want.keys()
        noisy = total = 0
        for key in (k for k in want if k.startswith(".params")):
            mu = key.replace(".params", ".opt_state.mu", 1)
            g = np.abs(want[mu] - MU_B1 * mu0[mu[len(".opt_state.mu"):]]) \
                / (1 - MU_B1)
            dg = np.abs(want[mu] - got[mu]) / (1 - MU_B1)
            noise = dg > NOISE * g
            d = np.abs(got[key] - want[key])
            assert d[~noise].max(initial=0) <= PARAM_ATOL, key
            assert d[noise].max(initial=0) <= 2 * LR, key
            noisy += int(noise.sum())
            total += noise.size
        assert noisy <= NOISE_SHARE * total, (noisy, total)
        flipped = total = 0
        for key in (k for k in want if k.startswith(".err_state")):
            # a residual is at most half an int8 step of its chunk; an entry
            # the packages quantise one step apart (its gradient at a
            # rounding boundary) differs by that step, at most twice the
            # leaf's largest residual
            d = np.abs(got[key] - want[key])
            assert d.max(initial=0) <= 2 * np.abs(want[key]).max(
                initial=0) + PARAM_ATOL, key
            flipped += int((d > PARAM_ATOL).sum())
            total += d.size
        assert flipped <= NOISE_SHARE * max(total, 1), (flipped, total)


def _params(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jax.jit(lambda k: jmdl.init_params(k, jcfg))(jax.random.PRNGKey(3))
    return jcfg, jp, interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")


COMPRESS_LEAVES = {"rows": ((48, 100), (None, 1)),
                   "both": ((48, 100), (0, 1)),
                   "vector": ((4100,), (0, None))}
FORWARD_ARCHS = ("qwen1.5-4b", "rwkv6-3b")


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Both launches at once: (i) on 8 ranks (4 x 2); (ii), (iv), (v) and
    (vi) on 4 ranks (2 x 2).  The JAX references of (iv)-(vi) are computed
    while the ranks run."""
    llama, llama_traj = train_job("llama3-405b", steps=1)
    qwen, qwen_traj = train_job("qwen1.5-4b", mesh_options=True,
                                microbatches=2, compress_grads=True)
    npr = np.random.RandomState(5)
    forward, fwd_ref = {}, {}
    for arch in FORWARD_ARCHS:
        jcfg, jp, tp = _params(arch)
        x = npr.randint(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
        forward[arch] = {"arch": arch, "replace": {"dtype": "float32"},
                         "params": tp, "inputs": torch.as_tensor(x)}
        fwd_ref[arch] = (jcfg, jp, x)
    decode = {}
    jcfg, jp, tp = _params("llama3-405b")
    for name, b in (("batch", 4), ("seq_shard", 1)):
        toks = npr.randint(0, jcfg.vocab_size, (b, 6)).astype(np.int32)
        decode[name] = {"arch": "llama3-405b",
                        "replace": {"dtype": "float32"}, "params": tp,
                        "tokens": torch.as_tensor(toks), "max_len": 32}
    compress = {}
    for name, (shape, dims) in COMPRESS_LEAVES.items():
        g = npr.randn(*shape).astype(np.float32) * np.exp(
            npr.randn(*shape)).astype(np.float32)
        e = 0.01 * npr.randn(*shape).astype(np.float32)
        compress[name] = {"g": torch.as_tensor(g), "e": torch.as_tensor(e),
                          "shard_dims": dims}
    wait_8 = launch(tmp_path_factory.mktemp("mesh4x2"),
                    {"mesh": (4, 2), "train": {"llama": llama}}, world=8)
    wait_4 = launch(tmp_path_factory.mktemp("mesh2x2"), {
        "mesh": (2, 2), "train": {"qwen": qwen}, "forward": forward,
        "decode": decode, "compress": compress}, world=4)

    want = {}
    for arch, (jc, p, x) in fwd_ref.items():
        want[arch] = np.asarray(jax.jit(lambda p, t: jmdl.forward(
            p, jc, t, remat=False)[0])(p, x))
    step = jax.jit(lambda p, s, t: jmdl.decode_step(p, jcfg, s, t))
    for name, job in decode.items():
        toks = job["tokens"].numpy()
        st = jmdl.init_decode_state(jcfg, toks.shape[0], job["max_len"])
        outs = []
        for t in range(toks.shape[1]):
            lg, st = step(jp, st, toks[:, t:t + 1])
            outs.append(np.asarray(lg))
        want[name] = np.concatenate(outs, axis=1)
    for name, job in compress.items():
        g, e = job["g"].numpy(), job["e"].numpy()
        rg, re_ = jgc.roundtrip(jnp.asarray(g), jnp.asarray(e))
        want["compress/" + name] = (np.asarray(rg), np.asarray(re_))
        want["compress/inputs/" + name] = (g, e)
    res = wait_4()
    res["llama"] = wait_8()["llama"]
    return res, {"llama": llama_traj, "qwen": qwen_traj}, want


def test_llama_step_on_4x2_matches_jax(meshes):
    res, trajectories, _ = meshes
    assert len(res["llama"]) == 1
    check_against_jax(res["llama"], trajectories["llama"])


def test_qwen_microbatched_compressed_step_with_every_mesh_option(meshes):
    res, trajectories, _ = meshes
    assert len(res["qwen"]) == 2
    check_against_jax(res["qwen"], trajectories["qwen"])


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_meshed_forward_matches_the_jax_forward(meshes, arch):
    res, _, want = meshes
    logits, kernel = res[arch]
    np.testing.assert_allclose(logits, want[arch], atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(kernel, want[arch], atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("name", ["batch", "seq_shard"])
def test_meshed_decode_matches_the_jax_decode(meshes, name):
    res, _, want = meshes
    assert res[name].shape == want[name].shape
    np.testing.assert_allclose(res[name], want[name], atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("name", list(COMPRESS_LEAVES))
def test_compression_on_shards_keeps_the_reference_chunks(meshes, name):
    res, _, want = meshes
    got_g, got_e = res["compress/" + name]
    want_g, want_e = want["compress/" + name]
    np.testing.assert_array_equal(got_g, want_g)
    np.testing.assert_array_equal(got_e, want_e)
    # the control: chunks counted per shard (each shard's own flat order)
    # are not the reference's
    shape, dims = COMPRESS_LEAVES[name]
    g0 = np.asarray(meshes[2]["compress/inputs/" + name][0])
    e0 = np.asarray(meshes[2]["compress/inputs/" + name][1])
    per_shard = g0.copy()
    index = [[slice(None)] for _ in shape]
    for d in (d for d in dims if d is not None):
        index[d] = [slice(0, shape[d] // 2), slice(shape[d] // 2, None)]
    for pieces in itertools.product(*index):
        rg, _ = jgc.roundtrip(jnp.asarray(g0[pieces]),
                              jnp.asarray(e0[pieces]))
        per_shard[pieces] = np.asarray(rg)
    assert not np.array_equal(per_shard, want_g)
