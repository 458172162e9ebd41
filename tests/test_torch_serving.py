"""The port's continuous-batching engine and LM launcher.

The four behavioural cases of ``tests/test_serving.py`` on the port's
engine (``qwen1.5-4b-smoke``, bfloat16, parameters from the port's
``init_params`` on the CPU), and a continuous-admission case whose
generated tokens equal the JAX engine's, token for token, for the same
parameters (carried across with ``interop.params_from_numpy``) and the same
prompts, in float32 for the dense, RWKV-6, MoE (GQA and MLA) and hybrid
smoke configs.  That case admits requests into released slots mid-run, so
it also holds the port to the reference's shared write index and its
unreset recurrent and latent slot state (ROADMAP §C); the hybrid's dict of
caches is merged per slot.  The JAX test of compiled-
program reuse has no counterpart (PyTorch compiles nothing); instead every
decode step is shown to take the full ``num_slots`` batch.  And the
launcher's LM path on the CPU for every decoder family.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, interop
from repro_torch.launch import serve
from repro_torch.models import init_decode_state, init_params, model
from repro_torch.runtime import ContinuousBatchingEngine
from repro_torch.runtime.serving import _merge_slot


@pytest.fixture(scope="module")
def setup():
    cfg = configs.get("qwen1.5-4b", smoke=True)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _greedy(cfg, params, prompt, gen_len):
    state = init_decode_state(cfg, 1, 64, device="cpu")
    logits = None
    for t in prompt:
        logits, state = model.decode_step(params, cfg, state,
                                          torch.tensor([[int(t)]]))
    out = [int(logits[0, -1].argmax())]
    for _ in range(gen_len - 1):
        logits, state = model.decode_step(params, cfg, state,
                                          torch.tensor([[out[-1]]]))
        out.append(int(logits[0, -1].argmax()))
    return out


def test_single_request_matches_sequential_decode(setup):
    cfg, params = setup
    prompt = np.array([3, 17, 42, 7], np.int32)
    eng = ContinuousBatchingEngine(cfg, params, num_slots=2, max_len=64)
    eng.submit(prompt, max_new_tokens=6)
    done = eng.run_until_drained()
    assert len(done) == 1
    assert done[0].generated == _greedy(cfg, params, prompt, 6)


def test_concurrent_requests_all_complete(setup):
    cfg, params = setup
    eng = ContinuousBatchingEngine(cfg, params, num_slots=4, max_len=64)
    rng = np.random.default_rng(0)
    n_req = 10
    for i in range(n_req):
        eng.submit(rng.integers(0, cfg.vocab_size, size=3 + i % 4),
                   max_new_tokens=4 + i % 5)
    done = eng.run_until_drained()
    assert len(done) == n_req
    for r in done:
        assert r.state == "done"
        assert len(r.generated) >= r.max_new_tokens - 1


def test_continuous_admission_keeps_slots_busy(setup, monkeypatch):
    """More requests than slots: released slots are refilled mid-run, and
    every decode step takes the whole fixed batch of num_slots rows."""
    cfg, params = setup
    shapes = []
    decode_step = model.decode_step

    def recording(p, c, state, tokens):
        shapes.append((tuple(tokens.shape),
                       tuple(state.caches[0].shape[:2])))
        return decode_step(p, c, state, tokens)

    monkeypatch.setattr(model, "decode_step", recording)
    eng = ContinuousBatchingEngine(cfg, params, num_slots=2, max_len=64)
    rng = np.random.default_rng(1)
    for _ in range(6):
        eng.submit(rng.integers(0, cfg.vocab_size, size=2),
                   max_new_tokens=3)
    done = eng.run_until_drained()
    assert len(done) == 6
    assert eng.occupancy > 0.5
    assert len(shapes) == eng.metrics["steps"]
    assert set(shapes) == {((2, 1), (cfg.num_layers, 2))}


def test_isolation_between_slots(setup):
    """A request's output does not depend on what shares the batch."""
    cfg, params = setup
    prompt = np.array([5, 9, 21], np.int32)
    eng1 = ContinuousBatchingEngine(cfg, params, num_slots=4, max_len=64)
    eng1.submit(prompt, max_new_tokens=5)
    alone = eng1.run_until_drained()[0].generated
    eng2 = ContinuousBatchingEngine(cfg, params, num_slots=4, max_len=64)
    uid = eng2.submit(prompt, max_new_tokens=5)
    rng = np.random.default_rng(2)
    for _ in range(3):
        eng2.submit(rng.integers(0, cfg.vocab_size, size=4),
                    max_new_tokens=5)
    together = [r for r in eng2.run_until_drained()
                if r.uid == uid][0].generated
    assert alone == together


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "rwkv6-3b",
                                  "granite-moe-3b-a800m", "deepseek-v2-236b",
                                  "zamba2-7b"])
def test_engine_tokens_equal_the_jax_engine(arch, monkeypatch):
    import jax
    from repro import configs as jcfgs
    from repro.models import init_params as jax_init
    from repro.runtime.serving import ContinuousBatchingEngine as JaxEngine
    jcfg = dataclasses.replace(jcfgs.get(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(configs.get(arch, smoke=True),
                               dtype="float32")
    jp = jax_init(jax.random.PRNGKey(4), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   tcfg, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, size=2 + i % 3)
               for i in range(5)]
    engines = (JaxEngine(jcfg, jp, num_slots=2, max_len=32),
               ContinuousBatchingEngine(tcfg, tp, num_slots=2, max_len=32))
    # record, every tick, the shared index and the active slots' own
    # positions
    ticks = []
    decode_step = model.decode_step

    def recording(p, c, state, tokens):
        eng = engines[1]
        ticks.append((state.index, [int(eng.slot_pos[s]) for s, r in
                                    enumerate(eng.slot_req) if r]))
        return decode_step(p, c, state, tokens)

    monkeypatch.setattr(model, "decode_step", recording)
    results = []
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(p, max_new_tokens=2 + i % 3)
        done = eng.run_until_drained()
        results.append({r.uid: (r.slot, r.generated) for r in done})
    assert results[0] == results[1]
    assert len(results[1]) == 5
    # a request admitted into a released slot is written at the shared
    # index, above its own position, while the other slot is busy
    assert any(idx > min(pos) for idx, pos in ticks)


def test_merge_slot_selects_along_the_slot_axis():
    new, old = torch.ones(3, 4, 2), torch.zeros(3, 4, 2)
    mask = torch.tensor([True, False, True, False])
    got = _merge_slot(new, old, mask)
    assert torch.equal(got[:, 0], new[:, 0]) and torch.equal(got[:, 1],
                                                              old[:, 1])
    scalar = torch.tensor(3)
    assert _merge_slot(scalar, torch.tensor(0), mask) is scalar


def test_engine_merges_the_hybrid_dict_cache_per_slot(monkeypatch):
    """zamba2's caches are a dict of tuples ({"trunk": (conv, ssm),
    "shared": (k, v)}); after a tick with only slot 0 active, every leaf
    of slot 1 keeps its previous contents."""
    cfg = configs.get("zamba2-7b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ContinuousBatchingEngine(cfg, params, num_slots=2, max_len=16)
    before = {k: tuple(c.clone() for c in v)
              for k, v in eng.state.caches.items()}
    eng.submit(np.array([3, 4, 5], np.int32), max_new_tokens=2)
    assert eng.step()
    after = eng.state.caches
    assert set(after) == {"trunk", "shared"}
    for key in after:
        for new, old in zip(after[key], before[key]):
            assert torch.equal(new[:, 1], old[:, 1])       # slot 1 frozen
    assert not torch.equal(after["trunk"][1][:, 0], before["trunk"][1][:, 0])


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "rwkv6-3b", "qwen2-vl-72b",
                                  "granite-moe-3b-a800m", "deepseek-v2-236b",
                                  "zamba2-7b"])
def test_launcher_lm_path_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "5", "--gen", "4", "--device", "cpu"])
    assert out["tokens"].shape == (2, 4)
    assert out["device"] == "cpu"
    assert torch.isfinite(out["logits"].float()).all()
    text = capsys.readouterr().out
    assert f"arch={arch}-smoke batch=2 prompt=5 gen=4" in text
    # the same seed gives the same tokens
    again = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                        "--prompt-len", "5", "--gen", "4", "--device",
                        "cpu"])
    assert torch.equal(again["tokens"], out["tokens"])


def test_launcher_refuses_what_it_does_not_serve():
    """An encoder-only arch and a missing --arch exit; every decoder family
    is served (``test_launcher_lm_path_on_cpu``)."""
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"])                   # no --arch
    with pytest.raises(SystemExit):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", "qwen1.5-4b", "--smoke"])
