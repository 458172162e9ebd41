"""The port's dry run (``repro_torch.launch.{shapes,dryrun}``) against the
JAX package's.

  * ``shapes``: ``SHAPES``, ``skip_reason``, ``runnable_cells`` (31 cells
    over the ten configs), ``input_specs`` (shapes and types; ``meta``
    tensors where the reference has ``ShapeDtypeStruct``s) and
    ``tokens_per_step`` equal the reference's;
  * ``_rules``, ``_attn_tp`` and ``_train_state_specs`` equal the
    reference's on abstract 16 × 16 and 2 × 16 × 16 meshes, leaf for leaf
    (a layer's leaf of the port's ``blocks`` list against the reference's
    stacked leaf without its leading ``None``);
  * ``model_flops`` equals the reference's formula
    (``model_flops_train`` / ``_decode`` of ``active_param_count`` and
    ``tokens_per_step``) for every runnable cell;
  * ``python -m repro_torch.launch.dryrun`` as its own process (it starts
    a fake process group of 256 ranks) on the cheapest full cells, one per
    kind: ``qwen1.5-4b`` × ``train_4k`` (one microbatch: the 16 of the
    default run the same products in 16 pieces and take 16 times as
    long), ``prefill_32k`` and ``decode_32k``.  Each reports ``ok`` with
    the reference's result keys, and its per-rank product FLOPs × 256 are
    within 1 % of a reckoning from the config's shapes
    (``reckoned_flops``).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host devices) when it is
imported; the import here restores the environment, so no other test's
JAX backend sees those devices.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import configs as jcfgs
from repro.analysis import roofline as jrf
from repro.distributed import sharding as jshd
from repro.launch import shapes as jshp
from repro.optim import optimizer as jopt
from repro.runtime import train_loop as jtl
from repro_torch import configs as tcfgs
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.spec import P
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import shapes as tshp
from repro_torch.optim import optimizer as topt
from repro_torch.runtime import train_loop as ttl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_TIMEOUT_S = 240        # the cells share the host with the other tests
FLOPS_RTOL = 1e-2


def _import_reference_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


jdr = _import_reference_dryrun()

MESHES = [((16, 16), ("data", "model"), False),
          ((2, 16, 16), ("pod", "data", "model"), True)]
# the result keys of the reference's lower_cell (an "ok" cell)
REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "tag", "lower_s",
                  "compile_s", "memory", "collective_bytes",
                  "collective_ops", "xla_cost_analysis", "roofline"}
REFERENCE_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                         "generated_code_bytes"}
REFERENCE_ROOFLINE_KEYS = {
    "compute_s", "memory_s", "collective_s", "hlo_flops", "hlo_bytes",
    "collective_bytes", "model_flops", "useful_ratio", "chips",
    "solve_iteration_s", "dominant", "step_time_s", "mfu"}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def test_shapes_table_equals_the_reference():
    assert list(tshp.SHAPES) == list(jshp.SHAPES)
    for name, cell in jshp.SHAPES.items():
        got = tshp.SHAPES[name]
        assert (got.name, got.kind, got.seq_len, got.global_batch) == \
            (cell.name, cell.kind, cell.seq_len, cell.global_batch)


@pytest.mark.parametrize("arch", jcfgs.names())
def test_skip_reasons_and_runnable_cells_equal_the_reference(arch):
    jc, tc = jcfgs.get(arch), tcfgs.get(arch)
    for shape in jshp.SHAPES:
        assert tshp.skip_reason(tc, shape) == jshp.skip_reason(jc, shape)
    assert tshp.runnable_cells(tc) == jshp.runnable_cells(jc)


def test_thirty_one_runnable_cells():
    total = sum(len(tshp.runnable_cells(tcfgs.get(a)))
                for a in tcfgs.names())
    assert total == sum(len(jshp.runnable_cells(jcfgs.get(a)))
                        for a in jcfgs.names()) == 31


@pytest.mark.parametrize("arch", jcfgs.names())
def test_input_specs_and_tokens_equal_the_reference(arch):
    jc, tc = jcfgs.get(arch), tcfgs.get(arch)
    for shape in jshp.runnable_cells(jc):
        want = jshp.input_specs(jc, shape)
        got = tshp.input_specs(tc, shape)
        assert list(got) == list(want)
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(spec.shape), (shape, key)
            assert _dtype_name(got[key].dtype) == jnp.dtype(spec.dtype).name
        assert tshp.tokens_per_step(tc, shape) == \
            jshp.tokens_per_step(jc, shape)


# ---------------------------------------------------------------------------
# rules and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("layout", ["2d", "dp"])
def test_rules_equal_the_reference(multi_pod, layout):
    got, want = tdr._rules(multi_pod, layout), jdr._rules(multi_pod, layout)
    assert (got.data, got.model, got.pod) == (want.data, want.model,
                                              want.pod)
    assert got.batch_axes == want.batch_axes


def _same_specs(got, want):
    """The port's spec tree (``blocks`` a list of layers) against the
    reference's (``blocks`` stacked on a leading L axis)."""
    want_flat = {jax.tree_util.keystr(p): s for p, s in
                 jax.tree_util.tree_leaves_with_path(
                     want, is_leaf=lambda x: isinstance(x, jax.sharding
                                                        .PartitionSpec))}
    n = 0

    def walk(tree, path):
        nonlocal n
        if isinstance(tree, P):
            key = "".join(f"[{k!r}]" for k in path
                          if not isinstance(k, int))
            layer = [k for k in path if isinstance(k, int)]
            spec = tuple(want_flat[key])
            if layer:
                assert spec[0] is None, key
                spec = spec[1:]
            assert tuple(tree) == spec, (key, tree, spec)
            n += 1
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            raise AssertionError(f"{path}: {tree!r}")

    walk(got, ())
    return n


@pytest.mark.parametrize("arch", jcfgs.names())
def test_attn_tp_and_train_state_specs_equal_the_reference(arch):
    jc, tc = jcfgs.get(arch), tcfgs.get(arch)
    jstate = jtl.make_train_state_abstract(
        jc, jopt.adamw(1e-4, state_dtype=jnp.bfloat16))
    tstate = ttl.make_train_state_abstract(
        tc, topt.adamw(1e-4, state_dtype=torch.bfloat16))
    for sizes, names, multi_pod in MESHES:
        jm, tm = jshd.abstract_mesh(sizes, names), \
            tshd.abstract_mesh(sizes, names)
        jr, tr = jdr._rules(multi_pod), tdr._rules(multi_pod)
        attn_tp = tdr._attn_tp(tc, tm, tr)
        assert attn_tp == jdr._attn_tp(jc, jm, jr)
        want = jdr._train_state_specs(jstate, jr, jm, attn_tp=attn_tp)
        got = tdr._train_state_specs(tstate, tr, tm, attn_tp=attn_tp)
        assert tuple(got.opt_state.step) == tuple(want.opt_state.step) == ()
        assert got.err_state is None and want.err_state is None
        n_leaves = len(pytree.tree_leaves(tstate.params))
        for got_tree, want_tree in ((got.params, want.params),
                                    (got.opt_state.mu, want.opt_state.mu),
                                    (got.opt_state.nu, want.opt_state.nu)):
            assert _same_specs(got_tree, want_tree) == n_leaves


def test_model_flops_equal_the_reference_for_every_runnable_cell():
    cells = 0
    for arch in jcfgs.names():
        jc, tc = jcfgs.get(arch), tcfgs.get(arch)
        for shape in jshp.runnable_cells(jc):
            toks = jshp.tokens_per_step(jc, shape)
            n = jc.active_param_count()
            want = (jrf.model_flops_train(n, toks)
                    if jshp.SHAPES[shape].kind == "train"
                    else jrf.model_flops_decode(n, toks))
            assert tdr.model_flops(tc, shape) == want, (arch, shape)
            cells += 1
    assert cells == 31


# ---------------------------------------------------------------------------
# the cells, each in its own process
# ---------------------------------------------------------------------------

def reckoned_flops(cfg, shape: str, n_model: int, attn_tp: bool) -> float:
    """The product FLOPs of one step of a dense model summed over the ranks,
    reckoned from the config's shapes.  Per layer, N_attn = the four
    attention projections, N_mlp the MLP's; T tokens, B sequences of S.

      * train (remat "nothing"): the blocks' products forward, recomputed
        and twice in the backward, 8·N·T, less the MLP down projection's
        recompute (non-reentrant checkpointing stops once the saved
        tensors are back), 2·d·d_ff·T; the head 6·d·V·T; the plain
        attention's two products 16·L·B·H·S²·D;
      * prefill: 2·N·T, the head 2·d·V·T (every position), the attention
        4·L·B·H·S²·D;
      * decode: 2·N·B, the head 2·d·V·B, the attention over the padded
        cache 4·L·B·H·S·D.

    Where the heads do not divide the model axis (``attn_tp`` False) the
    attention projections, and in train and prefill the attention itself,
    run whole on every rank of that axis: × ``n_model``.  The MLP and the
    head split over it, and so does the decode attention, whose cache is
    split over the sequence."""
    cell = tshp.SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len
    L, d, f, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n_attn = 2 * d * H * D + 2 * d * Hkv * D
    n_mlp = (3 if cfg.mlp_activation == "silu" else 2) * d * f
    rep = 1 if attn_tp else n_model
    if cell.kind == "train":
        T = B * S
        return (L * T * (8.0 * (rep * n_attn + n_mlp) - 2.0 * d * f)
                + 6.0 * d * V * T + 16.0 * L * B * H * S * S * D * rep)
    if cell.kind == "prefill":
        T = B * S
        return (2.0 * L * T * (rep * n_attn + n_mlp) + 2.0 * d * V * T
                + 4.0 * L * B * H * S * S * D * rep)
    return (2.0 * L * B * (rep * n_attn + n_mlp) + 2.0 * d * V * B
            + 4.0 * L * B * H * S * D)


CELLS = [("train_4k", ["--microbatches", "1"]), ("prefill_32k", []),
         ("decode_32k", [])]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each cell's result, the three run at once in processes of their
    own."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-4b", "--shape", shape, "--out", str(out)] + extra,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for shape, extra in CELLS}
    logs = {}
    for shape, p in procs.items():
        try:
            logs[shape] = p.communicate(timeout=CELL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, logs[shape][1][-3000:]
    return {shape: json.loads((out / f"qwen1.5-4b_{shape}_16x16.json")
                              .read_text()) for shape, _ in CELLS}


@pytest.mark.parametrize("shape", [c for c, _ in CELLS])
def test_cell_runs_with_the_reference_keys(cells, shape):
    res = cells[shape]
    assert res["status"] == "ok", res.get("error")
    assert REFERENCE_KEYS <= set(res)
    assert REFERENCE_MEMORY_KEYS <= set(res["memory"])
    assert REFERENCE_ROOFLINE_KEYS <= set(res["roofline"])
    assert {"flops", "bytes_accessed", "note"} <= set(
        res["xla_cost_analysis"])
    assert res["roofline"]["chips"] == 256
    assert res["memory"]["argument_bytes"] > 0
    assert res["collective_bytes"]["total"] > 0
    assert res["census"]["custom_calls"] == {}


@pytest.mark.parametrize("shape", [c for c, _ in CELLS])
def test_cell_flops_match_the_reckoning(cells, shape):
    cfg = tcfgs.get("qwen1.5-4b")
    mesh = tshd.abstract_mesh((16, 16), ("data", "model"))
    attn_tp = tdr._attn_tp(cfg, mesh, tdr._rules(False))
    assert not attn_tp                 # 20 heads on a model axis of 16
    got = cells[shape]["roofline"]["hlo_flops"] * 256
    want = reckoned_flops(cfg, shape, 16, attn_tp)
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)
    # the control: the attention whole on every rank left out
    assert abs(got - reckoned_flops(cfg, shape, 16, True)) > \
        FLOPS_RTOL * want
    assert cells[shape]["roofline"]["model_flops"] == \
        tdr.model_flops(cfg, shape)
