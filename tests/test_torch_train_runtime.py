"""The port's training runtime: remat, the loop, fault tolerance, the
launcher, the abstract state, and the stochastic adapters under the loop.

  * ``forward(remat=True)`` under each of ``REMAT_POLICIES`` gives the loss
    and the gradients of ``remat=False`` bit for bit (the port's
    counterpart of ``test_smoke_remat_matches_no_remat``, with gradients),
    in every family — the MoE aux term and the Mamba state included — and
    the blocks really are recomputed in the backward; under
    ``torch.no_grad()`` remat changes nothing and checkpoints nothing;
  * ``init_params_abstract`` / ``make_train_state_abstract`` give the
    reference's shapes and types on the ``meta`` device;
  * the reference's ``TestTrainLoopE2E`` and ``TestFaultTolerance``
    (``tests/test_runtime.py``) on the port, with the resume bit for bit
    on the CPU;
  * ``use_kernel=True`` training raises in both packages (the port
    ``NotImplementedError``; the JAX package's Pallas JVP rule fails, its
    kernels having no derivative rule);
  * the launcher with ``--smoke --device cpu`` trains, checkpoints and
    resumes; ``--mesh 1x1`` trains as the plain run does (a mesh larger
    than the world raises; the mesh options take ``NamedSharding``s); the
    default device is ``cuda`` and raises on a host without one;
  * ``examples/bilevel_datareweight.py::main_data_scale``'s replay of the
    inner fit through ``train_loop`` (its small size, θ fixed) equals the
    reference's (float32, 1e-6), and a run restarted from a checkpoint at
    ``start_step=k`` equals the uninterrupted one bit for bit.
"""
import dataclasses
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import models as JM
from repro import configs as jcfgs
from repro.data.pipeline import (DataConfig as JDataConfig,
                                 PrefetchIterator as JPrefetch,
                                 SyntheticLMStream as JStream)
from repro_torch import configs
from repro_torch import stochastic as tsto
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLMStream
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as mdl
from repro_torch.optim import adamw, sgd
from repro_torch.runtime import (ElasticPlan, HeartbeatRegistry,
                                 PreemptionHandler, StragglerMonitor,
                                 TrainStepConfig, make_train_state,
                                 make_train_step, run_train_loop)
from repro_torch.runtime import train_loop as ttl

FAMILIES = {"qwen1.5-4b": "_dense_block",
            "granite-moe-3b-a800m": "_dense_block",
            "deepseek-v2-236b": "_dense_block",
            "rwkv6-3b": "_rwkv_block", "zamba2-7b": "_mamba_block"}


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(configs.get(arch, smoke=True), dtype=dtype)


def _batch(cfg, B=2, S=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, cfg.vocab_size, (B, S), generator=g),
            torch.randint(0, cfg.vocab_size, (B, S), generator=g))


@pytest.mark.parametrize("policy", sorted(mdl.REMAT_POLICIES))
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_remat_matches_no_remat(arch, policy, monkeypatch):
    cfg = _cfg(arch)
    params = mdl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x, y = _batch(cfg)
    loss0, g0 = ttl.make_value_and_grad(
        cfg, TrainStepConfig(remat=False))(params, x, y)
    calls = []
    block = getattr(mdl, FAMILIES[arch])

    def counted(*args, **kwargs):
        calls.append(1)
        return block(*args, **kwargs)

    monkeypatch.setattr(mdl, FAMILIES[arch], counted)
    loss, g = ttl.make_value_and_grad(cfg, TrainStepConfig(
        remat=True, remat_policy=policy))(params, x, y)
    assert len(calls) == 2 * cfg.num_layers     # forward + recompute
    assert torch.equal(loss, loss0)
    for a, b in zip(pytree.tree_leaves(g), pytree.tree_leaves(g0)):
        assert torch.equal(a, b)


def test_remat_changes_nothing_without_autograd(monkeypatch):
    cfg = _cfg("qwen1.5-4b", "bfloat16")
    params = mdl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x, _ = _batch(cfg)
    with torch.no_grad():
        want, _ = mdl.forward(params, cfg, x, remat=False)

    def refuse(*args, **kwargs):
        raise AssertionError("checkpointed under no_grad")

    monkeypatch.setattr(mdl._ckpt, "checkpoint", refuse)
    with torch.no_grad():
        got, _ = mdl.forward(params, cfg, x)      # remat=True by default
    assert torch.equal(got, want)
    assert torch.equal(ttl.make_prefill_step(cfg)(params, x), want)


def test_unknown_remat_policy_and_mesh_options_raise():
    cfg = _cfg("qwen1.5-4b")
    params = mdl.init_params(cfg, device="cpu")
    x, y = _batch(cfg)
    with pytest.raises(KeyError):
        mdl.loss_fn(params, cfg, x, y, remat_policy="everything")
    # the mesh options take NamedShardings (their mesh runs:
    # tests/test_torch_mesh_training.py)
    with pytest.raises(TypeError, match="NamedSharding"):
        mdl.forward(params, cfg, x, act_sharding=object())
    for name in ("microbatch_sharding", "grad_sharding", "act_sharding",
                 "sp_sharding"):
        with pytest.raises(TypeError, match="NamedSharding"):
            make_train_step(cfg, adamw(1e-3),
                            TrainStepConfig(**{name: object()}))


def _shapes(tree, stack=None):
    """{JAX key path: (shape, dtype name)} of a port parameter tree (its
    ``blocks`` stacked) or of the reference's abstract tree."""
    if stack is not None:
        blocks = {jax.tree_util.keystr(k): (stack,) + tuple(v.shape)
                  for k, v in jax.tree_util.tree_leaves_with_path(
                      pytree.tree_map(lambda t: np.empty(0), tree["blocks"][0]))}
        out = {}
        for name, sub in tree.items():
            for k, v in jax.tree_util.tree_leaves_with_path(
                    pytree.tree_map(lambda t: t, sub) if name != "blocks"
                    else tree["blocks"][0]):
                key = f"['{name}']" + jax.tree_util.keystr(k)
                shape = tuple(v.shape)
                out[key] = ((stack,) + shape if name == "blocks" else shape,
                            str(v.dtype).split(".")[-1])
        return out
    return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_abstract_params_and_state_match_reference(arch):
    jcfg, tcfg = jcfgs.get(arch, smoke=True), configs.get(arch, smoke=True)
    abstract = mdl.init_params_abstract(tcfg)
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(abstract))
    want = _shapes(JM.init_params_abstract(jax.random.PRNGKey(0), jcfg))
    assert _shapes(abstract, stack=tcfg.num_layers) == want
    state = ttl.make_train_state_abstract(tcfg, adamw(1e-3), compress=True)
    assert state.opt_state.step.device.type == "meta"
    assert state.opt_state.step.dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in
               pytree.tree_leaves((state.opt_state.mu, state.err_state)))


def test_step_updates_the_state_in_place():
    cfg = _cfg("qwen1.5-4b")
    opt = adamw(1e-3)
    state = make_train_state(cfg, opt, device="cpu")
    kept = pytree.tree_map(lambda t: None if t is None else t.clone(), state)
    step = make_train_step(cfg, opt, TrainStepConfig(remat=False))
    new, metrics = step(state, *_batch(cfg))
    assert new.params["blocks"][0]["attn"]["w_q"] is \
        state.params["blocks"][0]["attn"]["w_q"]
    assert new.opt_state is state.opt_state and int(metrics["step"]) == 1
    assert not torch.equal(state.params["embed"]["tok"],
                           kept.params["embed"]["tok"])
    assert int(kept.opt_state.step) == 0         # a clone keeps the old


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "rwkv6-3b"])
def test_use_kernel_training_raises_in_both(arch, monkeypatch):
    import repro.kernels.flash_attention.ops as fa_ops
    import repro.kernels.rwkv_wkv.ops as wkv_ops
    fa, wkv = fa_ops.flash_attention, wkv_ops.wkv
    monkeypatch.setattr(fa_ops, "flash_attention",
                        lambda q, k, v, causal=True: fa(
                            q, k, v, causal=causal, interpret=True))
    monkeypatch.setattr(wkv_ops, "wkv",
                        lambda r, k, v, w, u, state0=None: wkv(
                            r, k, v, w, u, state0, interpret=True))
    jcfg = dataclasses.replace(jcfgs.get(arch, smoke=True), dtype="float32")
    tcfg = _cfg(arch)
    x, y = SyntheticLMStream(DataConfig(vocab_size=jcfg.vocab_size,
                                        seq_len=16,
                                        global_batch=4)).batch_at(0)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    # the forward runs through the kernels; the gradient does not
    JM.loss_fn(params, jcfg, x, y, use_kernel=True, remat=False)
    with pytest.raises(AssertionError):
        jax.value_and_grad(lambda p: JM.loss_fn(
            p, jcfg, x, y, use_kernel=True, remat=False))(params)
    with pytest.raises(NotImplementedError, match="forward only"):
        make_train_step(tcfg, adamw(1e-3),
                        TrainStepConfig(use_kernel=True))


# ---------------------------------------------------------------------------
# the reference's TestTrainLoopE2E, on the port
# ---------------------------------------------------------------------------

def _data_iter(stream, start=0):
    step = start
    while True:
        yield step, stream.batch_at(step)
        step += 1


def test_loss_decreases_and_resume_is_exact(tmp_path):
    cfg = configs.get("qwen1.5-4b", smoke=True)
    optimizer = adamw(3e-3, weight_decay=0.0)
    step_fn = make_train_step(cfg, optimizer,
                              TrainStepConfig(microbatches=1, remat=False))
    state = make_train_state(cfg, optimizer, device="cpu")
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=32, global_batch=4))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    monitor = StragglerMonitor()
    state, hist = run_train_loop(step_fn, state, _data_iter(stream),
                                 num_steps=30, checkpoint_manager=mgr,
                                 checkpoint_every=10, monitor=monitor,
                                 log_every=1)
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0]
    assert mgr.latest_step() == 30 and mgr.all_steps() == [20, 30]
    assert len(monitor.times[0]) == monitor.window     # the last 20
    assert [int(h["step"]) for h in hist] == list(range(1, 31))
    target = make_train_state(cfg, optimizer,
                              torch.Generator().manual_seed(9), device="cpu")
    restored = mgr.restore(20, target)
    state2, hist2 = run_train_loop(step_fn, restored, _data_iter(stream, 20),
                                   num_steps=10, log_every=1, start_step=20)
    assert [h["loss"] for h in hist2] == losses[20:]   # bit for bit
    for a, b in zip(pytree.tree_leaves(state2.params),
                    pytree.tree_leaves(state.params)):
        assert torch.equal(a, b)


def test_preemption_checkpoints_and_stops(tmp_path):
    cfg = configs.get("qwen1.5-4b", smoke=True)
    optimizer = adamw(1e-3)
    step_fn = make_train_step(cfg, optimizer, TrainStepConfig(remat=False))
    state = make_train_state(cfg, optimizer, device="cpu")
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=16, global_batch=2))
    handler = PreemptionHandler()
    calls = {"n": 0}

    def flag():
        calls["n"] += 1
        if calls["n"] == 3:
            handler.preempt()
        return handler()

    mgr = CheckpointManager(str(tmp_path))
    state, hist = run_train_loop(step_fn, state, _data_iter(stream),
                                 num_steps=100, checkpoint_manager=mgr,
                                 checkpoint_every=1000,
                                 preemption_flag=flag, log_every=1)
    assert len(hist) == 3
    assert mgr.latest_step() == 3
    assert int(state.opt_state.step) == 3


def test_grad_compression_training_still_converges():
    cfg = configs.get("qwen1.5-4b", smoke=True)
    optimizer = adamw(3e-3, weight_decay=0.0)
    step_fn = make_train_step(cfg, optimizer, TrainStepConfig(
        remat=False, compress_grads=True))
    state = make_train_state(cfg, optimizer, compress=True, device="cpu")
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=32, global_batch=4))
    losses = []
    for step in range(25):
        state, m = step_fn(state, *stream.batch_at(step))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert any(float(e.abs().max()) > 0 for e in
               pytree.tree_leaves(state.err_state))


def test_microbatched_step_matches_full_batch():
    cfg = configs.get("llama3-405b", smoke=True)
    optimizer = sgd(1e-2, momentum=0.0)
    s1 = make_train_state(cfg, optimizer, device="cpu")
    s2 = pytree.tree_map(lambda t: None if t is None else t.clone(), s1)
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=16, global_batch=8))
    x, y = stream.batch_at(0)
    full = make_train_step(cfg, optimizer, TrainStepConfig(
        microbatches=1, remat=False))
    micro = make_train_step(cfg, optimizer, TrainStepConfig(
        microbatches=4, remat=False))
    s1, m1 = full(s1, x, y)
    s2, m2 = micro(s2, x, y)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-2)
    w1 = pytree.tree_leaves(s1.params)[0]
    w2 = pytree.tree_leaves(s2.params)[0]
    np.testing.assert_allclose(w1.float().numpy(), w2.float().numpy(),
                               atol=1e-2)


# ---------------------------------------------------------------------------
# the reference's TestFaultTolerance, on the port
# ---------------------------------------------------------------------------

def test_straggler_detection():
    mon = StragglerMonitor(window=10, threshold=1.5)
    for step in range(10):
        for host in range(8):
            mon.record(step, 0.1 if host != 3 else 0.25, host=host)
    assert mon.stragglers() == [3]


def test_no_false_positives():
    mon = StragglerMonitor()
    for step in range(10):
        for host in range(8):
            mon.record(step, 0.1 + 0.001 * host, host=host)
    assert mon.stragglers() == []


def test_heartbeat_failure_detection():
    t = [0.0]
    reg = HeartbeatRegistry(timeout=10.0, clock=lambda: t[0])
    for h in range(4):
        reg.ping(h)
    t[0] = 5.0
    reg.ping(0); reg.ping(1); reg.ping(2)
    t[0] = 12.0
    assert reg.failed_hosts() == [3]
    assert sorted(reg.healthy_hosts()) == [0, 1, 2]


def test_preemption_handler():
    h = PreemptionHandler()
    assert not h()
    h.preempt()
    assert h()


def test_preemption_handler_installs_on_the_main_thread_only():
    before = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler(install=True)
    try:
        assert signal.getsignal(signal.SIGTERM) == h._on_signal
        signal.raise_signal(signal.SIGTERM)
        assert h()
    finally:
        h.restore()
    assert signal.getsignal(signal.SIGTERM) == before
    made = []
    worker = threading.Thread(
        target=lambda: made.append(PreemptionHandler(install=True)))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive() and len(made) == 1
    assert signal.getsignal(signal.SIGTERM) == before


def test_elastic_plan():
    plan = ElasticPlan(old_data=16, old_model=16)
    nd, nm = plan.survivor_mesh(failed_fraction=0.1)
    assert nm == 16 and nd < 16 and 16 % nd == 0
    assert plan.batch_scale(0.1) == nd / 16


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "10"]
    first = train_launcher.main(argv + ["--steps", "20"])
    assert first["device"] == "cpu" and first["start_step"] == 0
    assert [int(h["step"]) for h in first["history"]] == [1, 11]
    assert CheckpointManager(str(tmp_path)).all_steps() == [10, 20]
    second = train_launcher.main(argv + ["--steps", "25"])
    assert second["start_step"] == 20
    assert [int(h["step"]) for h in second["history"]] == [21]
    out = capsys.readouterr().out
    assert "[train] resumed from step 20" in out
    assert out.count("[train] done") == 2
    assert CheckpointManager(str(tmp_path)).latest_step() == 25


def test_launcher_mesh_raises_and_device_defaults_to_cuda():
    import torch.distributed as dist
    argv = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "16"]
    # a mesh larger than the world raises; 1x1 trains on a single-rank gloo
    # group the launcher starts and ends (multi-rank: the mesh tests)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        train_launcher.main(argv + ["--mesh", "2x1"])
    meshed = train_launcher.main(argv + ["--mesh", "1x1", "--steps", "3"])
    plain = train_launcher.main(argv + ["--steps", "3"])
    assert meshed["mesh"] == (1, 1) and plain["mesh"] is None
    assert not dist.is_initialized()
    for a, b in zip(meshed["history"], plain["history"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_launcher.main(["--arch", "qwen1.5-4b", "--smoke"])


# ---------------------------------------------------------------------------
# the stochastic adapters under the real train_loop
# ---------------------------------------------------------------------------

VOCAB, SEQ, STREAM_BATCH, MINIBATCH, STEPS_PER_DOMAIN = 32, 8, 32, 16, 16


def _dataset(make_config, make_stream, prefetch):
    """main_data_scale's two domains (the second with random labels)."""
    def collect(seed, corrupt):
        cfg = make_config(vocab_size=VOCAB, seq_len=SEQ,
                          global_batch=STREAM_BATCH, seed=seed)
        with prefetch(make_stream(cfg), daemon=False) as it:
            xs, ys = zip(*(it.batch_at(s) for s in range(STEPS_PER_DOMAIN)))
        x, y = np.concatenate(xs), np.concatenate(ys)
        if corrupt:
            rng = np.random.default_rng(seed + 999)
            y = rng.integers(0, VOCAB, size=y.shape).astype(np.int32)
        return x, y

    (xc, yc), (xb, yb) = collect(0, False), collect(1, True)
    dom = np.concatenate([np.zeros(len(xc), np.int32),
                          np.ones(len(xb), np.int32)])
    return np.concatenate([xc, xb]), np.concatenate([yc, yb]), dom


def _jax_inner(W, batch, lam):
    xb, (yb, db) = batch
    logp = jax.nn.log_softmax(W[xb], axis=-1)
    ce = -jnp.take_along_axis(logp, yb[..., None], axis=-1)[..., 0]
    weights = 2.0 * jax.nn.softmax(lam)[db]
    return jnp.mean(weights * jnp.mean(ce, axis=-1)) + 1e-2 * jnp.sum(W ** 2)


def _torch_inner(W, batch, lam):
    xb, (yb, db) = batch
    logp = torch.log_softmax(W[xb], dim=-1)
    ce = -torch.gather(logp, -1, yb.long()[..., None])[..., 0]
    weights = 2.0 * torch.softmax(lam, dim=0)[db]
    return torch.mean(weights * ce.mean(dim=-1)) + 1e-2 * torch.sum(W ** 2)


THETA = np.array([0.7, -0.7], np.float32)


def _port_replay():
    from repro_torch.data import DataConfig as TDC
    x, y, dom = _dataset(TDC, SyntheticLMStream, PrefetchIterator)
    sampler = tsto.MinibatchSampler(data=(x, (y, dom)),
                                    batch_size=MINIBATCH, seed=0,
                                    device="cpu")
    solver = tsto.Adam(_torch_inner, sampler=sampler, stepsize=5e-2,
                       epochs=2, averaging="polyak",
                       average_from=sampler.num_batches)
    theta = torch.tensor(THETA)
    step = tsto.make_stochastic_train_step(solver, theta)
    W0 = torch.zeros(VOCAB, VOCAB)
    return (x, y, dom), sampler, solver, step, \
        (W0, solver.init_state(W0, theta))


def test_stochastic_replay_under_train_loop_matches_jax():
    from repro import stochastic as jsto
    from repro.runtime.train_loop import train_loop as jloop
    (x, y, dom), sampler, solver, step, carry0 = _port_replay()
    jx, jy, jdom = _dataset(JDataConfig, JStream, JPrefetch)
    for a, b in ((x, jx), (y, jy), (dom, jdom)):
        np.testing.assert_array_equal(a, b)
    jsampler = jsto.MinibatchSampler(
        data=(jnp.asarray(jx), (jnp.asarray(jy), jnp.asarray(jdom))),
        batch_size=MINIBATCH, seed=0)
    jsolver = jsto.Adam(_jax_inner, sampler=jsampler, stepsize=5e-2,
                        epochs=2, averaging="polyak",
                        average_from=jsampler.num_batches)
    jtheta = jnp.asarray(THETA)
    jW0 = jnp.zeros((VOCAB, VOCAB), jnp.float32)
    n = solver.num_steps()
    assert n == jsolver.num_steps() == 2 * sampler.num_batches
    jcarry, jhist = jloop(jsto.make_stochastic_train_step(jsolver, jtheta),
                          (jW0, jsolver.init_state(jW0, jtheta)),
                          jsto.stochastic_data_iter(jsampler), num_steps=n,
                          log_every=16)
    carry, hist = run_train_loop(step, carry0,
                                 tsto.stochastic_data_iter(sampler),
                                 num_steps=n, log_every=16)
    assert len(hist) == len(jhist) == n // 16
    for h, j in zip(hist, jhist):
        assert h["step"] == j["step"]
        np.testing.assert_allclose(h["loss"], j["loss"], rtol=1e-6)
        np.testing.assert_allclose(h["grad_norm"], j["grad_norm"],
                                   rtol=1e-5)
    np.testing.assert_allclose(carry[0].numpy(), np.asarray(jcarry[0]),
                               rtol=1e-6, atol=1e-6)


def test_stochastic_replay_restarts_from_a_checkpoint(tmp_path):
    _, sampler, solver, step, carry0 = _port_replay()
    n, k = solver.num_steps(), 40
    full, hist = run_train_loop(step, carry0,
                                tsto.stochastic_data_iter(sampler),
                                num_steps=n, log_every=8)
    _, sampler, solver, step, carry0 = _port_replay()
    mgr = CheckpointManager(str(tmp_path))
    run_train_loop(step, carry0, tsto.stochastic_data_iter(sampler),
                   num_steps=k, checkpoint_manager=mgr, checkpoint_every=k,
                   log_every=8)
    assert mgr.latest_step() == k
    _, _, _, _, target = _port_replay()
    resumed_at, carry = mgr.restore_latest(target)
    assert carry[1].iter_num == k
    carry, hist2 = run_train_loop(step, carry,
                                  tsto.stochastic_data_iter(sampler, k),
                                  num_steps=n - k, log_every=8, start_step=k)
    assert hist2 == hist[k // 8:]
    for a, b in zip(pytree.tree_leaves(carry), pytree.tree_leaves(full)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
