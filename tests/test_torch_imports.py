"""The PyTorch port stands alone: it imports neither JAX nor the JAX package.

An AST scan of every module under ``src/repro_torch/`` and of
``chip_smoke.py``: no ``import jax`` / ``from jax ...`` and no
``import repro`` / ``from repro ...`` (``repro_torch`` itself is fine).
The port's observability package exports the reference's public names,
``jit_event`` and ``jit_event_pair`` among them, and those two deliver the
same events as ``emit`` and ``emit_pair``.  ``repro_torch.stochastic``
exports the reference's ``__all__`` and ``repro_torch.analysis`` its
``autotune``, ``roofline`` and ``op_census`` (the census in ``hlo``'s
place).  ``repro_torch.core`` exports
every public name of ``repro.core`` but those of the parts still queued.

Every ported submodule (each module of ``repro_torch`` whose counterpart
exists in ``repro``) carries its reference's public names: the reference's
``__all__`` where it has one; where it has none, its public top-level
functions, classes and UPPER-case constants — those defined there, those
it binds under another name (``projection_simplex_ref``), and a package's
re-exports — apart from the names listed below with their reason.
``repro_torch.distributed.spec`` has no reference module (the reference
imports ``P`` from ``jax.sharding``).  The training stack (``optim``,
``data``, ``checkpoint``, ``runtime.fault_tolerance``, the train step and
loop, ``launch.train``) and the dry run (``launch.shapes``,
``launch.dryrun``) carry every reference name, and importing the dry run
starts no process group.  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when
it is imported; the imports here restore the environment.
"""
import ast
import importlib
import os
import subprocess
import sys
import inspect
import pathlib
import pkgutil

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
# reference names a ported submodule does not carry, and why
_PALLAS_LEVEL = "Pallas-level: each port's kernel.launch takes their place"
NOT_MIRRORED = {
    "repro_torch.analysis.autotune": (
        {"block_b_candidates", "choose_block_b", "default_block_b",
         "measure_block_schedule"},
        "B.1's layout schedule replaces the TPU's block_b schedule"),
    "repro_torch.kernels.batched_cg.kernel": (
        {"LANES", "batched_cg_pallas", "pad_to_lanes"}, _PALLAS_LEVEL),
    "repro_torch.kernels.flash_attention.kernel": (
        {"NEG_INF", "flash_attention_bhsd"}, _PALLAS_LEVEL),
    "repro_torch.kernels.rwkv_wkv.kernel": ({"wkv_bh"}, _PALLAS_LEVEL),
    "repro_torch.kernels.simplex_proj.kernel": (
        {"projection_simplex_rows"}, _PALLAS_LEVEL),
}


def _ported_submodules():
    """(port module, reference module) names of every ported submodule."""
    import repro_torch
    out = []
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        ref = "repro" + info.name[len("repro_torch"):]
        if importlib.util.find_spec(ref.rsplit(".", 1)[0]) is not None and \
                importlib.util.find_spec(ref) is not None:
            out.append((info.name, ref))
    return out


def _public_names(mod):
    """A reference module's public names (see the module docstring)."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    is_pkg = hasattr(mod, "__path__")
    out = set()
    for name, obj in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        owner = getattr(obj, "__module__", None) or ""
        if inspect.isfunction(obj) or inspect.isclass(obj):
            if owner == mod.__name__ or (owner.split(".")[0] == "repro" and (
                    is_pkg or name != obj.__name__)):
                out.add(name)
        elif name.isupper():
            out.add(name)
    return out


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
                   "repro_torch/models/moe.py",
                   "repro_torch/models/mamba.py",
                   "repro_torch/models/model.py",
                   "repro_torch/interop.py",
                   "repro_torch/runtime/solve_service.py",
                   "repro_torch/runtime/serving.py",
                   "repro_torch/runtime/train_loop.py",
                   "repro_torch/launch/serve.py",
                   "repro_torch/stochastic/sampler.py",
                   "repro_torch/stochastic/solvers.py",
                   "repro_torch/stochastic/host.py",
                   "repro_torch/analysis/roofline.py",
                   "repro_torch/analysis/autotune.py",
                   "repro_torch/analysis/op_census.py",
                   "repro_torch/distributed/__init__.py",
                   "repro_torch/distributed/spec.py",
                   "repro_torch/distributed/sharded_operators.py",
                   "repro_torch/distributed/sharding.py",
                   "repro_torch/distributed/pipeline.py",
                   "repro_torch/launch/mesh.py",
                   "repro_torch/optim/__init__.py",
                   "repro_torch/optim/optimizer.py",
                   "repro_torch/optim/schedules.py",
                   "repro_torch/optim/grad_compression.py",
                   "repro_torch/data/__init__.py",
                   "repro_torch/data/pipeline.py",
                   "repro_torch/checkpoint/__init__.py",
                   "repro_torch/checkpoint/checkpointer.py",
                   "repro_torch/runtime/fault_tolerance.py",
                   "repro_torch/launch/train.py",
                   "repro_torch/launch/shapes.py",
                   "repro_torch/launch/dryrun.py"):
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


def test_stochastic_and_analysis_export_the_reference_names():
    import repro.stochastic as reference
    import repro_torch
    import repro_torch.analysis as analysis
    import repro_torch.stochastic as port
    assert port.__all__ == reference.__all__
    for name in reference.__all__:
        assert hasattr(port, name), name
    assert "stochastic" in repro_torch.__all__
    assert "analysis" in repro_torch.__all__
    for name in ("autotune", "op_census", "roofline"):
        assert name in analysis.__all__ and hasattr(analysis, name)


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


SUBMODULES = _ported_submodules()


def test_every_new_module_of_the_slice_is_a_ported_submodule():
    names = {port for port, _ in SUBMODULES}
    for module in ("repro_torch.distributed",
                   "repro_torch.distributed.sharded_operators",
                   "repro_torch.distributed.sharding",
                   "repro_torch.distributed.pipeline",
                   "repro_torch.launch.mesh",
                   "repro_torch.observability.events",
                   "repro_torch.kernels.simplex_proj.ref",
                   "repro_torch.models.moe",
                   "repro_torch.models.mamba",
                   "repro_torch.optim",
                   "repro_torch.optim.optimizer",
                   "repro_torch.optim.schedules",
                   "repro_torch.optim.grad_compression",
                   "repro_torch.data",
                   "repro_torch.data.pipeline",
                   "repro_torch.checkpoint",
                   "repro_torch.checkpoint.checkpointer",
                   "repro_torch.runtime.fault_tolerance",
                   "repro_torch.runtime.train_loop",
                   "repro_torch.launch.train",
                   "repro_torch.launch.shapes",
                   "repro_torch.launch.dryrun"):
        assert module in names, module
    assert "repro_torch.distributed.spec" not in names


def _reference(name):
    """``importlib.import_module(name)`` with ``os.environ`` as it was
    (``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import)."""
    saved = dict(os.environ)
    try:
        return importlib.import_module(name)
    finally:
        os.environ.clear()
        os.environ.update(saved)


@pytest.mark.parametrize("port_name,ref_name", SUBMODULES,
                         ids=[port for port, _ in SUBMODULES])
def test_ported_submodule_carries_the_reference_names(port_name, ref_name):
    reference = _reference(ref_name)
    port = importlib.import_module(port_name)
    skipped, _why = NOT_MIRRORED.get(port_name, (set(), ""))
    want = _public_names(reference)
    assert skipped <= want, f"{port_name}: stale exceptions {skipped - want}"
    missing = sorted(n for n in want - skipped if not hasattr(port, n))
    assert not missing, f"{port_name} lacks {missing} of {ref_name}"
    if hasattr(reference, "__all__"):
        assert set(reference.__all__) <= set(getattr(port, "__all__", ())), \
            f"{port_name}.__all__ lacks " \
            f"{sorted(set(reference.__all__) - set(port.__all__))}"


def test_importing_the_dry_run_starts_no_process_group():
    out = subprocess.run(
        [sys.executable, "-c", "import torch.distributed as dist; "
         "import repro_torch.launch.dryrun, repro_torch.launch.shapes; "
         "print(dist.is_initialized())"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"
