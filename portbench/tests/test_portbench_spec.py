"""The harness resolves every piece ``BENCHMARK.json`` names, by name, and
fails on a missing one."""
import json
import re
import shutil

import pytest

from portbench.tests.smoke import CELLS, ROOT
from portbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves():
    bench = spec.load_benchmark()
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.chips == 1
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        assert callable(cell.reference.forward)
        assert callable(cell.reference.step_flops)
        assert {m["name"] for m in cell.end_to_end} == {
            "prefill_tok_s", "ttft_p95_ms", "peak_mem_gib", "setup_s"}
        for name, module in cell.per_layer.items():
            assert callable(module.read), name
        cfg = spec.port_config(cell.config)
        assert cfg.name == cell.config["port"]["arch"]


def test_the_file_holds_the_configuration_as_run():
    """Every size the port runs with comes from the configuration file."""
    import dataclasses
    from repro_torch import configs

    def resolved(cfg):
        return dataclasses.replace(cfg, head_dim=cfg.resolved_head_dim)
    for w in spec.load_benchmark()["workloads"]:
        cell = spec.load_cell(w["name"])
        assert resolved(spec.port_config(cell.config)) == resolved(
            configs.get(cell.config["port"]["arch"]))


def test_names_and_keys_keep_to_the_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for x in ("end_to_end", "per_layer")
                   for n in (m["name"] for m in bench[x]))) == \
        len(bench["end_to_end"]) + len(bench["per_layer"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("missing", [
    "portbench/traffic/score-128x2048.json",
    "portbench/configs/rwkv6-3b.json",
    "portbench/reference/gqa_moe.py",
    "portbench/metrics/eager.ms_per_step.py",
    "portbench/limits/rwkv6-3b.score-128x2048.json",
])
def test_a_missing_piece_fails(tmp_path, missing):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / missing).unlink()
    with pytest.raises(spec.MissingPiece, match=re.escape(
            missing.rsplit("/", 1)[1].rsplit(".", 1)[0])):
        for cell in CELLS:
            spec.load_cell(cell, tmp_path)


def test_an_unknown_workload_fails():
    with pytest.raises(spec.MissingPiece, match="no workload"):
        spec.load_cell("no-such-cell")


def test_a_new_metric_is_a_new_file_and_entry(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "steps.count", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "prefill_tok_s", "workloads": [CELLS[1]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench/metrics/steps.count.py").write_text(
        "def read(run):\n    return run.trace.steps\n")
    # every cell loads every reader; one that finds nothing returns None
    for cell in CELLS:
        assert "steps.count" in spec.load_cell(cell, tmp_path).per_layer


@pytest.mark.parametrize("arch,field,key,value", [
    ("granite-moe-3b-a800m", "moe.top_k", "experts_per_token", 4),
    ("zamba2-7b", "ssm.state_size", "d_state", 128),
    ("rwkv6-3b", "num_layers", "depth", 3),
])
def test_a_field_of_any_group_maps_from_the_file(arch, field, key, value):
    """``<group>.<field>`` sets a field of the port's nested group without
    an edit to the harness."""
    import dataclasses
    from repro_torch import configs
    cfg = spec.port_config({"name": "x", key: value,
                            "port": {"arch": arch, "fields": {field: key}}})
    group, _, sub = field.rpartition(".")
    got = getattr(getattr(cfg, group), sub) if group else getattr(cfg, sub)
    assert got == value
    base = configs.get(arch)
    if group:
        assert dataclasses.replace(getattr(cfg, group), **{
            sub: getattr(getattr(base, group), sub)}) == getattr(base, group)
