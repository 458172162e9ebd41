"""The PyTorch port stands alone: it imports neither JAX nor the JAX package.

An AST scan of every module under ``src/repro_torch/`` and of
``chip_smoke.py``: no ``import jax`` / ``from jax ...`` and no
``import repro`` / ``from repro ...`` (``repro_torch`` itself is fine).
The port's observability package exports the reference's public names,
``jit_event`` and ``jit_event_pair`` among them, and those two deliver the
same events as ``emit`` and ``emit_pair``.  ``repro_torch.core`` exports
every public name of ``repro.core`` but those of the parts still queued.
"""
import ast
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")
# the public names of repro.observability, each exported by the port
OBSERVABILITY_NAMES = (
    "EVENT_KINDS", "SolveEvent", "observe", "observing",
    "observing_iterations", "emit", "jit_event", "jit_event_pair",
    "subscribe", "recorded", "clear_recorded",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "global_registry",
    "reset_global_registry", "DEFAULT_BUCKETS", "ITERATION_BUCKETS",
    "LATENCY_BUCKETS",
    "Span", "Tracer", "configure_tracer", "current_tracer",
    "remove_tracer", "span",
    "load_trace", "summarize", "format_summary",
)
# names of repro.core that belong to queue A items 5-8 (stochastic,
# analysis, distributed, the rest of the LM stack) and so are not in
# repro_torch.core yet: none — repro.core exports none of theirs
LATER_CORE_NAMES = frozenset()


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_modules():
    names = {p.relative_to(REPO / "src").as_posix() for p in FILES[:-1]}
    for module in ("repro_torch/core/operators.py",
                   "repro_torch/core/linear_solve.py",
                   "repro_torch/core/diff_api.py",
                   "repro_torch/core/implicit_diff.py",
                   "repro_torch/core/solver_runtime.py",
                   "repro_torch/core/optimality.py",
                   "repro_torch/core/projections.py",
                   "repro_torch/core/prox.py",
                   "repro_torch/core/solvers.py",
                   "repro_torch/core/bilevel.py",
                   "repro_torch/core/implicit_layer.py",
                   "repro_torch/kernels/batched_cg/ops.py",
                   "repro_torch/kernels/simplex_proj/ops.py",
                   "repro_torch/kernels/flash_attention/ops.py",
                   "repro_torch/kernels/flash_attention/kernel.py",
                   "repro_torch/kernels/flash_attention/ref.py",
                   "repro_torch/kernels/rwkv_wkv/ops.py",
                   "repro_torch/kernels/rwkv_wkv/kernel.py",
                   "repro_torch/kernels/rwkv_wkv/ref.py",
                   "repro_torch/configs/__init__.py",
                   "repro_torch/configs/base.py",
                   "repro_torch/configs/qwen1_5_4b.py",
                   "repro_torch/configs/rwkv6_3b.py",
                   "repro_torch/models/__init__.py",
                   "repro_torch/models/layers.py",
                   "repro_torch/models/rwkv.py",
                   "repro_torch/models/model.py",
                   "repro_torch/interop.py",
                   "repro_torch/runtime/solve_service.py",
                   "repro_torch/runtime/serving.py",
                   "repro_torch/runtime/train_loop.py",
                   "repro_torch/launch/serve.py"):
        assert module in names
    assert (REPO / "chip_smoke.py").exists()
    for name in ("flash_attention", "rwkv_wkv"):
        assert (REPO / "src" / "repro_torch" / "kernels" / name / "csrc"
                / f"{name}.cu").exists()
    configs = {p.name for p in (REPO / "src" / "repro" / "configs")
               .glob("*.py")}
    assert configs == {p.name for p in (REPO / "src" / "repro_torch" /
                                        "configs").glob("*.py")}


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(REPO)
                         .as_posix())
def test_no_jax_or_repro_imports(path):
    bad = sorted({root for root in _imported_roots(path)
                  if root in BANNED})
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("name", OBSERVABILITY_NAMES)
def test_port_exports_observability_name(name):
    import repro.observability as reference
    import repro_torch.observability as port
    assert name in reference.__all__
    assert name in port.__all__ and hasattr(port, name)


def test_jit_events_deliver_what_emit_delivers():
    from repro_torch import observability as obs

    def stream(single, pair):
        obs.clear_recorded()
        with obs.observe(True, record=True):
            assert obs.observing()
            single("solve", {"solver": "cg", "B": 3},
                   iterations=np.array([4, 7, 2]), converged=True)
            pair("backward_start", "backward_done", {"backward": "cg"},
                 residual=np.float32(1e-6))
        events = [(ev.kind, ev.tags, ev.values) for ev in obs.recorded()]
        obs.clear_recorded()
        return events

    want = stream(obs.emit, obs.emit_pair)
    got = stream(obs.jit_event, obs.jit_event_pair)
    assert [kind for kind, _, _ in got] == ["solve", "backward_start",
                                            "backward_done"]
    assert len(got) == len(want)
    for (kind, tags, values), (kind_w, tags_w, values_w) in zip(got, want):
        assert kind == kind_w and tags == tags_w
        assert values.keys() == values_w.keys()
        for key in values:
            np.testing.assert_array_equal(values[key], values_w[key])


def test_core_exports_what_the_reference_core_exports():
    import repro.core as reference
    import repro_torch.core as port
    public = {name for name in vars(reference) if not name.startswith("_")}
    missing = sorted(public - set(vars(port)) - LATER_CORE_NAMES)
    assert not missing, f"repro_torch.core lacks {missing}"
    for name in ("SampledJacobianOperator", "BlockDiagonal",
                 "ComposedOperator", "solve_bicgstab", "solve_gmres",
                 "solve_neumann", "deq_fixed_point", "make_deq_block",
                 "make_deq_solver"):
        assert name in public and hasattr(port, name), name
