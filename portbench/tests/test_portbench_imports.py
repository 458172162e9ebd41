"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references import nothing of the program."""
import ast
import json
import subprocess
import sys

import pytest

from portbench.tests.smoke import ROOT
from portbench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_run_and_references_load_no_jax():
    code = f"""
import json, runpy, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
run = runpy.run_path({str(ROOT / 'portbench/run.py')!r})
from portbench.harness import cellrun, compare, spec, trace
from portbench import calibrate
for w in spec.load_benchmark()["workloads"]:
    cell = spec.load_cell(w["name"])
    cellrun.program_step(spec.port_config(cell.config))
    trace.port_kernels()
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_check_compares_whole_top_level_names():
    run = spec.load_module(ROOT / "portbench/run.py", "run")
    sys.modules.setdefault("repro_torch_probe", type(sys)("probe"))
    try:
        assert "repro_torch_probe" not in run.forbidden_modules()
        assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    finally:
        del sys.modules["repro_torch_probe"]


@pytest.mark.parametrize("path", sorted(
    (spec.BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_only_torch(path):
    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods <= {"__future__", "math", "torch"}, mods
