"""The port's ``CheckpointManager`` against ``repro.checkpoint``.

The reference's ``TestCheckpoint`` cases on the port (round trip, keep-N,
atomic publish, shape mismatch rejected, async save), the port's own
properties (``save`` copies to host memory before it returns, ``restore``
lands in the target's tensors, ``meta`` targets, bfloat16 bit for bit,
Python numbers), and the file format both ways: a JAX ``TrainState``
saved by ``repro.checkpoint.CheckpointManager`` restores into the port's
and the port's save restores in the reference, each equal bit for bit to
``interop``'s crossing, and one AdamW step from each side then agrees
within the train-step tolerances of ``tests/test_torch_train_loop.py``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import configs as jcfgs
from repro import optim as jopt
from repro.checkpoint import CheckpointManager as JManager
from repro.runtime import train_loop as jtl
from repro_torch import configs, interop
from repro_torch import optim as topt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.runtime import train_loop as ttl

from test_torch_train_loop import check_step, jax_state, leaves_by_path


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 4, generator=g),
            "opt": {"mu": torch.ones(8, 4),
                    "step": torch.tensor(5, dtype=torch.int32)},
            "blocks": [{"a": torch.randn(3, generator=g)} for _ in range(2)]}


def _zeros_like(tree):
    return pytree.tree_map(torch.zeros_like, tree)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(100, tree, blocking=True)
    target = _zeros_like(tree)
    restored = mgr.restore(100, target)
    assert restored["w"] is target["w"]            # restored in place
    for a, b in zip(pytree.tree_leaves(restored), pytree.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(restored["opt"]["step"]) == 5


def test_file_layout_is_the_reference_one(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(), blocking=True)
    with open(tmp_path / "step_3" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["keys"] == ["blocks/a", "opt/mu", "opt/step", "w"]
    assert manifest["shapes"]["blocks/a"] == [2, 3]     # stacked layers
    with np.load(tmp_path / "step_3" / "host_0" / "shards.npz") as data:
        assert data["opt/step"].dtype == np.int32


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _tree(), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_atomic_no_partial_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))
    mgr.save(1, _tree(), blocking=True)
    assert mgr.all_steps() == [1]
    assert mgr.latest_step() == 1


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)}, blocking=True)
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(1, {"w": torch.zeros(5)})
    mgr.save(2, {"blocks": [{"w": torch.ones(4)}] * 2}, blocking=True)
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(2, {"blocks": [{"w": torch.zeros(3)}] * 2})


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, _tree(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 7


def test_save_copies_before_it_returns(tmp_path):
    """The train step updates its state in place: what an async save
    writes is the state as it was when ``save`` was called."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = pytree.tree_map(torch.clone, tree)
    mgr.save(1, tree)
    for t in pytree.tree_leaves(tree):
        t.add_(1)
    mgr.wait()
    got = mgr.restore(1, _zeros_like(tree))
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert torch.equal(a, b)


def test_restore_latest_meta_targets_and_numbers(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest({"w": torch.zeros(2)}) == (None, None)
    tree = {"w": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16),
            "n": 7, "x": np.arange(3, dtype=np.float32)}
    mgr.save(4, tree, blocking=True)
    target = {"w": torch.empty(2, 3, dtype=torch.bfloat16, device="meta"),
              "n": 0, "x": np.zeros(3, np.float32)}
    step, got = mgr.restore_latest(target)
    assert step == 4
    assert got["w"].device.type == "cpu" and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], tree["w"])
    assert got["n"] == 7 and isinstance(got["n"], int)
    np.testing.assert_array_equal(got["x"], tree["x"])


def test_a_tensor_shared_by_two_leaves_gets_one_each(tmp_path):
    """A solver state may hold one zero tree as both moments; restoring
    in place into it would give both leaves the last one's values."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"m": torch.ones(3), "v": 2 * torch.ones(3)}, blocking=True)
    zeros = torch.zeros(3)
    got = mgr.restore(1, {"m": zeros, "v": zeros})
    assert torch.equal(got["m"], torch.ones(3))
    assert torch.equal(got["v"], 2 * torch.ones(3))
    assert torch.equal(zeros, torch.zeros(3))


def test_bfloat16_round_trips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(1000, generator=g).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": w}, blocking=True)
    got = mgr.restore(1, {"w": torch.zeros_like(w)})["w"]
    assert torch.equal(got.view(torch.int16), w.view(torch.int16))


# ---------------------------------------------------------------------------
# the file format, both ways
# ---------------------------------------------------------------------------

ARCHS = ["qwen1.5-4b", "zamba2-7b"]


def _setup(arch, dtype="float32"):
    jcfg = dataclasses.replace(jcfgs.get(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(configs.get(arch, smoke=True), dtype=dtype)
    stream = SyntheticLMStream(DataConfig(vocab_size=jcfg.vocab_size,
                                          seq_len=16, global_batch=4))
    return jcfg, tcfg, stream


def _jax_state_after(jcfg, jo, jstep, stream, steps):
    state = jax_state(jcfg, jo)
    for k in range(steps):
        state, _ = jstep(state, *stream.batch_at(k))
    return state


def _equal_states(port, jax_state):
    got = leaves_by_path(interop.train_state_to_numpy(port))
    want = leaves_by_path(jax_state)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_in_the_port(arch, tmp_path):
    jcfg, tcfg, stream = _setup(arch)
    jo, to = jopt.adamw(1e-3), topt.adamw(1e-3)
    jstep = jax.jit(jtl.make_train_step(jcfg, jo,
                                        jtl.TrainStepConfig(remat=False)))
    jstate = _jax_state_after(jcfg, jo, jstep, stream, 2)
    JManager(str(tmp_path)).save(2, jstate, blocking=True)
    target = ttl.make_train_state(tcfg, to, torch.Generator().manual_seed(5),
                                  device="cpu")
    step, state = CheckpointManager(str(tmp_path)).restore_latest(target)
    assert step == 2 and state.params is not None
    _equal_states(state, jax.tree_util.tree_map(np.asarray, jstate))
    tstep = ttl.make_train_step(tcfg, to, ttl.TrainStepConfig(remat=False))
    check_step(jstep, tstep, jstate, state, stream.batch_at(2), mu_b1=0.9,
               lr=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    jcfg, tcfg, stream = _setup(arch)
    jo, to = jopt.adamw(1e-3), topt.adamw(1e-3)
    jstep = jax.jit(jtl.make_train_step(jcfg, jo,
                                        jtl.TrainStepConfig(remat=False)))
    tstep = ttl.make_train_step(tcfg, to, ttl.TrainStepConfig(remat=False))
    state = interop.train_state_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_state(jcfg, jo)), tcfg, device="cpu")
    for k in range(2):
        state, _ = tstep(state, *stream.batch_at(k))
    CheckpointManager(str(tmp_path)).save(2, state, blocking=True)
    target = jtl.make_train_state_abstract(jcfg, jo)
    jstate = JManager(str(tmp_path)).restore(2, target)
    _equal_states(state, jstate)
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
    check_step(jstep, tstep, jstate, state, stream.batch_at(2), mu_b1=0.9,
               lr=1e-3)


def test_bf16_state_crosses_both_ways_bit_for_bit(tmp_path):
    jcfg, tcfg, stream = _setup("qwen1.5-4b", "bfloat16")
    jo, to = jopt.adamw(1e-3), topt.adamw(1e-3)
    jstate = jax_state(jcfg, jo)
    JManager(str(tmp_path / "jax")).save(1, jstate, blocking=True)
    target = ttl.make_train_state(tcfg, to, device="cpu")
    state = CheckpointManager(str(tmp_path / "jax")).restore(1, target)
    assert state.params["blocks"][0]["attn"]["w_q"].dtype == torch.bfloat16
    want = jax.tree_util.tree_map(np.asarray, jstate)
    _equal_states(state, want)
    CheckpointManager(str(tmp_path / "port")).save(1, state, blocking=True)
    back = JManager(str(tmp_path / "port")).restore(1, jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
