"""The DeepSeek-V2 configuration and the two cells of 8,192-token
prompts: the file's cut, its mapping to the port, and the arithmetic of
its metrics."""
import dataclasses

import pytest

from portbench.harness import spec
from portbench.harness.peaks import PEAKS

DS = "deepseek-v2-236b.score-4x8192"
RWKV = "rwkv6-3b.prefill-1x8192"


def test_the_mla_bound_at_the_cells_shape():
    """2·(192 + 128) FLOP a head and causal pair: 11.0 TFLOP at 4 × 8,192
    and 128 heads, 11.12 ms at the bf16 peak; q, k, v, o 4.84 GB."""
    m = spec.load_module(spec.BENCH_DIR / "metrics" /
                         "mla_attention_roofline.py", "mla")
    sec, flops, nbytes = m.bound(4, 8192, 128, 128, 64, 128, PEAKS["H100"])
    assert flops / 1e12 == pytest.approx(10.996, abs=0.001)
    assert nbytes / 1e9 == pytest.approx(4.836, abs=0.001)
    assert sec * 1e3 == pytest.approx(11.119, abs=0.001)


@pytest.mark.parametrize("name,tflop", [(DS, 794.9), (RWKV, 44.8)])
def test_model_flops_of_a_step(name, tflop):
    """deepseek-v2: 7.07 G matrix parameters a token (MLA 149.2 M × 30,
    layer 0's MLP, 29 × (router, shared, 0.75 routed pairs), the head) and
    30 × 11.0 TFLOP of causal attention; rwkv6: as at 4 × 2,048."""
    cell = spec.load_cell(name)
    tr = cell.traffic
    flops = cell.reference.step_flops(cell.config, tr["batch"],
                                      tr["prompt_len"])
    assert flops / 1e12 == pytest.approx(tflop, rel=0.001)


def test_the_cut_keeps_the_floors():
    c = spec.load_cell(DS).config
    assert c["num_hidden_layers"] - c["first_k_dense_replace"] >= 4
    assert c["n_routed_experts"] >= 8
    assert c["router_experts"] == c["published"]["n_routed_experts"] == 160
    assert c["router_experts"] % c["n_group"] == 0
    assert c["n_routed_experts"] == c["router_experts"] // c["n_group"]
    cfg = spec.port_config(c)
    assert cfg.moe.held == (0, 20) and cfg.moe.num_experts == 160
    assert cfg.vocab_size == 102400 and cfg.moe_layer_start == 1


def test_the_port_reads_every_change_from_the_file():
    """Every field in which the cell's port config differs from the
    registered ``deepseek-v2-236b`` is one the file maps, and the YaRN
    fields are the file's ``rope_scaling`` group."""
    from repro_torch import configs
    c = spec.load_cell(DS).config
    fields = c["port"]["fields"]
    cfg, base = spec.port_config(c), configs.get(c["port"]["arch"])
    for f in dataclasses.fields(cfg):
        if f.name == "moe":
            for g in dataclasses.fields(cfg.moe):
                if getattr(cfg.moe, g.name) != getattr(base.moe, g.name):
                    assert f"moe.{g.name}" in fields, g.name
        elif getattr(cfg, f.name) != getattr(base, f.name):
            assert f.name in fields, f.name
    for key, value in c["rope_scaling"].items():
        if key != "type":
            assert c[f"rope_scaling.{key}"] == value, key
    assert cfg.yarn_factor == 40 and cfg.yarn_mscale_all_dim == 0.707


@pytest.mark.parametrize("name,batch,checked", [(DS, 4, 4), (RWKV, 1, 1)])
def test_the_traffic_of_the_long_prompt_cells(name, batch, checked):
    tr = spec.load_cell(name).traffic
    assert (tr["batch"], tr["prompt_len"], tr["checked"]) == \
        (batch, 8192, checked)
    assert tr["loop"] == "closed" and tr["pool_batches"] == 8
