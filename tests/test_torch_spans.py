"""The port's span API and the spans and counters of its forward, on the CPU.

  * A profiled prefill step of each benchmark configuration at its smoke
    size (``portbench/configs/*.json``, the ``smoke`` block) holds one range
    per block kind and layer, nested as ``models/model.py``'s docstring
    lists them, and as many per step as the model's depth gives (at full
    depth: 130 in granite, 98 in rwkv6); the dense and hybrid families open
    ``model.mlp``, ``model.mamba`` and ``model.shared_attention``.
  * With no profiler recording and no tracer installed, ``span`` is the
    shared no-op and never touches ``record_function`` (patched to raise,
    the forward still runs), and ``count`` adds nothing.
  * ``moe_expert_rows_total`` counts E·N computed and k·N routed rows under
    dense dispatch (routed ÷ computed = k/E), E·cap computed under the
    sparse gather and k·N computed under dropless dispatch (the forward
    made to take it on the CPU); under deepseek-v2-236b's expert share, in
    every layer the pairs routed here, at most the rows computed.
  * deepseek-v2-236b in bfloat16 opens ``kernels.mla_attention``,
    ``model.mlp`` in its dense layer 0 and ``model.moe.shared``.
  * On the card (``cuda`` marker): a forward without autograd (the size
    rule set to 0) takes dropless dispatch, counts k·N computed rows, and
    gives dense dispatch's logits within the bfloat16 two-path bound of
    ``tests/test_torch_model.py``.
  * The tracer's ``clock`` record places a span on the profiler's
    timeline within 1 ms of the same span's kineto start, and
    ``report.load_trace`` skips the record.
  * The train step's ``train_step/*`` ranges, now spans, are still in a
    CPU profile, and every port span begins with one of
    ``chip_smoke.PORT_SPANS``, the prefixes its profile splits leave out.
"""
import collections
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.models import model as mdl
from repro_torch.models import moe
from repro_torch.observability import metrics, report, spans
from repro_torch.optim import adamw
from repro_torch.runtime import (TrainStepConfig, make_prefill_step,
                                 make_train_state, make_train_step)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness import spec  # noqa: E402

PORT_PREFIXES = ("model.", "kernels.", "train_step/")


def _config(name):
    """``name`` at its smoke sizes in float32: the benchmark's configuration
    file's ``smoke`` block where the benchmark has one, else the port's."""
    path = REPO / "portbench" / "configs" / f"{name}.json"
    if path.is_file():
        c = json.loads(path.read_text())
        cfg = spec.port_config({**c, **c["smoke"]})
    else:
        cfg = configs.get(name, smoke=True)
    return dataclasses.replace(cfg, dtype="float32")


def _ranges(prof):
    """[(name, parent name or None)] of the port's ranges in ``prof``,
    the parent being the innermost port range enclosing it."""
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(PORT_PREFIXES)),
                    key=lambda e: (e.start_ns(), -e.duration_ns()))
    out, stack = [], []
    for e in events:
        start = e.start_ns()
        while stack and stack[-1][1] <= start:
            stack.pop()
        out.append((e.name(), stack[-1][0] if stack else None))
        stack.append((e.name(), start + e.duration_ns()))
    return out


def _expected(cfg):
    """{(name, parent): ranges a prefill step opens} for ``cfg``."""
    L = cfg.num_layers
    want = collections.Counter({("model.embed", None): 1,
                                ("model.head", None): 1})
    if cfg.family == "ssm":
        want.update({("model.time_mix", None): L,
                     ("kernels.rwkv_wkv", "model.time_mix"): L,
                     ("model.channel_mix", None): L})
    elif cfg.family == "hybrid":
        n = len(mdl._segments(cfg))
        want.update({("model.mamba", None): L,
                     ("model.shared_attention", None): n,
                     ("kernels.flash_attention",
                      "model.shared_attention"): n})
    else:
        want.update({("model.attention", None): L,
                     ("kernels.flash_attention", "model.attention"): L})
        if cfg.moe:
            want.update({("model.moe", None): L,
                         ("model.moe.router", "model.moe"): L})
        else:
            want.update({("model.mlp", None): L})
    return want


def _tokens(cfg, batch=2, seq=32):
    return torch.randint(0, cfg.vocab_size, (batch, seq),
                         generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "rwkv6-3b",
                                  "qwen1.5-4b", "zamba2-7b"])
def test_a_profiled_prefill_names_each_block_kind(name):
    cfg = _config(name)
    params = mdl.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_prefill_step(cfg, use_kernel=True)
    x = _tokens(cfg)
    step(params, x)
    with torch.profiler.profile() as prof:
        for _ in range(2):
            step(params, x)
    got = collections.Counter(_ranges(prof))
    want = _expected(cfg)
    assert got == collections.Counter({k: 2 * n for k, n in want.items()})


@pytest.mark.parametrize("name,per_step", [("granite-moe-3b-a800m", 130),
                                           ("rwkv6-3b", 98)])
def test_a_step_at_full_depth_opens_the_spans_the_benchmark_expects(
        name, per_step):
    c = json.loads((REPO / "portbench" / "configs" / f"{name}.json")
                   .read_text())
    cfg = spec.port_config(c)
    assert cfg.num_layers == 32
    assert sum(_expected(cfg).values()) == per_step


def test_span_off_never_touches_record_function(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("record_function opened with tracing off")
    monkeypatch.setattr(spans, "record_function", boom)
    assert spans.current_tracer() is None
    assert not torch.autograd._profiler_enabled()
    assert spans.span("a") is spans.span("b", layer=3)
    with spans.span("a") as sp:
        assert sp is None
    for name in ("granite-moe-3b-a800m", "rwkv6-3b"):
        cfg = _config(name)
        params = mdl.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        make_prefill_step(cfg, use_kernel=True)(params, _tokens(cfg))
    with pytest.raises(AssertionError, match="tracing off"):
        with torch.profiler.profile():
            with spans.span("a"):
                pass


def test_a_tracer_alone_records_spans_and_no_profiler_range(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("record_function opened without a profiler")
    monkeypatch.setattr(spans, "record_function", boom)
    tr = spans.configure_tracer()
    try:
        cfg = _config("granite-moe-3b-a800m")
        params = mdl.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        make_prefill_step(cfg, use_kernel=True)(params, _tokens(cfg))
        recs = tr.records()
    finally:
        spans.remove_tracer()
    by_id = {r["id"]: r for r in recs}
    pairs = collections.Counter(
        (r["name"], by_id[r["parent"]]["name"] if r["parent"] else None)
        for r in recs)
    assert pairs == _expected(cfg)
    assert all(r["type"] == "span" for r in recs)


def _rows(registry):
    values = registry.snapshot().get("moe_expert_rows_total",
                                     {"values": {}})["values"]
    return (values.get('kind="computed"', 0.0),
            values.get('kind="routed"', 0.0))


@pytest.mark.parametrize("dispatch", ["dense", "sparse", "dropless"])
def test_expert_rows_are_counted_only_while_tracing(dispatch, monkeypatch):
    cfg = _config("granite-moe-3b-a800m")
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    params = mdl.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    x = _tokens(cfg, batch=2, seq=16)
    N = x.numel()
    reg = metrics.global_registry()
    before = _rows(reg)
    if dispatch == "dropless":        # as on the card without autograd
        monkeypatch.setattr(mdl, "_dropless", lambda t, cfg: True)

    def fwd():
        with torch.no_grad():
            mdl.forward(params, cfg, x, remat=False,
                        moe_dispatch="sparse" if dispatch == "sparse"
                        else "dense")
    fwd()
    assert _rows(reg) == before
    with torch.profiler.profile():
        fwd()
    computed, routed = (a - b for a, b in zip(_rows(reg), before))
    rows = {"dense": E * N, "sparse": E * moe._capacity(2.0, N, k, E),
            "dropless": k * N}[dispatch]
    assert computed == cfg.num_layers * rows
    assert routed == cfg.num_layers * k * N
    if dispatch == "dense":
        assert 100.0 * routed / computed == pytest.approx(100.0 * k / E)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with `pytest -m cuda` on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_forward_on_the_card_runs_dropless_dispatch(cuda_device,
                                                      monkeypatch):
    """granite at its smoke size in bfloat16 (``DROPLESS_MIN_WASTE_FLOP``
    set to 0, which the published widths pass at the cells' sizes): a
    forward without autograd counts k·N computed rows; with autograd on
    (dense dispatch) its logits
    agree within ‖Δ‖/‖ref‖ ≤ 3e-2, and within atol 0.15, rtol 0.1 over the
    tokens routed alike in every layer (a changed expert is a jump, not a
    rounding)."""
    cfg = dataclasses.replace(_config("granite-moe-3b-a800m"),
                              dtype="bfloat16")
    k = cfg.moe.top_k
    params = mdl.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    x = _tokens(cfg).to(cuda_device)
    N = x.numel()
    real, sets = moe._router_probs, []

    def recording(p, m, h):
        gates, aux = real(p, m, h)
        sets.append(gates > 0)
        return gates, aux
    monkeypatch.setattr(moe, "_router_probs", recording)
    monkeypatch.setattr(mdl, "DROPLESS_MIN_WASTE_FLOP", 0)
    reg = metrics.global_registry()
    before = _rows(reg)
    with torch.no_grad(), torch.profiler.profile():
        got, _ = mdl.forward(params, cfg, x, remat=False)
    computed, routed = (a - b for a, b in zip(_rows(reg), before))
    assert computed == routed == cfg.num_layers * k * N
    with torch.enable_grad():
        want, _ = mdl.forward(params, cfg, x, remat=False)
    L = cfg.num_layers
    flipped = torch.stack([(a != b).any(-1)
                           for a, b in zip(sets[:L], sets[L:])]).any(0)
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.linalg.vector_norm(g - w) <= \
        3e-2 * torch.linalg.vector_norm(w)
    keep = ~flipped.cpu()
    torch.testing.assert_close(g[keep], w[keep], atol=0.15, rtol=0.1)


def test_a_profiled_deepseek_prefill_names_its_spans():
    """deepseek-v2-236b at its benchmark file's smoke size in bfloat16 (the
    MLA op's path): ``kernels.mla_attention`` inside every
    ``model.attention``, ``model.mlp`` in the dense layer 0, and inside
    every ``model.moe`` the router and ``model.moe.shared``."""
    cfg = dataclasses.replace(_config("deepseek-v2-236b"), dtype="bfloat16")
    assert cfg.moe_layer_start == 1 and cfg.moe.is_share
    params = mdl.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_prefill_step(cfg, use_kernel=True)
    x = _tokens(cfg)
    step(params, x)
    with torch.profiler.profile() as prof:
        step(params, x)
    L, n = cfg.num_layers, cfg.num_layers - cfg.moe_layer_start
    assert collections.Counter(_ranges(prof)) == collections.Counter({
        ("model.embed", None): 1, ("model.head", None): 1,
        ("model.attention", None): L,
        ("kernels.mla_attention", "model.attention"): L,
        ("model.mlp", None): L - n, ("model.moe", None): n,
        ("model.moe.router", "model.moe"): n,
        ("model.moe.shared", "model.moe"): n})


@pytest.mark.parametrize("dispatch", ["dense", "dropless"])
def test_expert_rows_under_a_share(dispatch, monkeypatch):
    """deepseek-v2-236b's smoke share (4 of 16 routed experts): in every
    layer the pairs routed here are counted as routed, at most the rows
    computed (E_held·N under dense dispatch, the routed pairs and one
    padding row under dropless dispatch), and only while tracing."""
    cfg = _config("deepseek-v2-236b")
    Eh = cfg.moe.held[1] - cfg.moe.held[0]
    params = mdl.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    x = _tokens(cfg, batch=2, seq=16)
    N = x.numel()
    if dispatch == "dropless":
        monkeypatch.setattr(mdl, "_dropless", lambda t, cfg: True)
    layers = []
    real = moe._count_rows

    def recording(computed, routed):
        real(computed, routed)
        layers.append((float(computed),
                       float(routed() if callable(routed) else routed)))
    monkeypatch.setattr(moe, "_count_rows", recording)
    reg = metrics.global_registry()
    before = _rows(reg)
    with torch.no_grad():
        mdl.forward(params, cfg, x, remat=False)
        assert _rows(reg) == before
        with torch.profiler.profile():
            mdl.forward(params, cfg, x, remat=False)
    got = [(a - b) for a, b in zip(_rows(reg), before)]
    n = cfg.num_layers - cfg.moe_layer_start
    assert len(layers) == 2 * n
    traced = layers[n:]
    assert got == [sum(c for c, _ in traced), sum(r for _, r in traced)]
    for computed, routed in traced:
        assert 0 < routed <= computed
        want = Eh * N if dispatch == "dense" else routed + 1
        assert computed == want


def test_the_clock_record_places_a_span_on_the_profiler_timeline(tmp_path):
    path = tmp_path / "trace.jsonl"
    tr = spans.configure_tracer(str(path))
    try:
        with torch.profiler.profile() as prof:
            time.sleep(0.01)
            with spans.span("probe.clock", note="x"):
                time.sleep(0.002)
        tr.flush()
    finally:
        spans.remove_tracer()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    clock = lines[0]
    assert clock["type"] == "clock" and clock == tr.clock
    (rec,) = [r for r in lines if r.get("name") == "probe.clock"]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe.clock"]
    assert abs(tr.epoch_ns(rec["ts"]) - ev.start_ns()) < 1e6
    loaded = report.load_trace(path)
    assert [r["type"] for r in loaded] == ["span"]
    assert loaded[0]["tags"] == {"note": "x"}


def _chip_smoke():
    path = REPO / "chip_smoke.py"
    module_spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def test_the_train_step_ranges_are_spans_in_a_cpu_profile():
    cfg = dataclasses.replace(configs.get("qwen1.5-4b", smoke=True),
                              dtype="float32")
    opt = adamw(1e-3)
    state = make_train_state(cfg, opt, torch.Generator().manual_seed(0),
                             compress=True, device="cpu")
    step = make_train_step(cfg, opt, TrainStepConfig(compress_grads=True))
    x = _tokens(cfg)
    with torch.profiler.profile() as prof:
        step(state, x, x)
    names = {e.key for e in prof.key_averages()}
    for part in ("forward_backward", "clip", "compress", "update"):
        assert f"train_step/{part}" in names
    smoke = _chip_smoke()
    assert smoke.PORT_SPANS == PORT_PREFIXES
    ours = {n for n in names if n.startswith(PORT_PREFIXES)}
    assert {"model.attention", "model.mlp", "model.head"} <= ours
    assert all(n.startswith(smoke.NOT_KERNELS) for n in ours)
