"""The port's distributed layer on several ranks, and its sharding rules.

Multi-rank runs on the CPU: each rank is a ``subprocess`` running
``python -c`` code that imports only ``torch``, numpy and ``repro_torch``
(never JAX), in a gloo group over a file store under ``tmp_path``, with a
60 s group timeout and a subprocess timeout, so a hung collective fails
the test instead of eating the suite's time.  One launch per world size
(2 and 4 ranks) runs every case; the JAX reference is computed here, in
the test process, from the same numpy inputs (float64):

  * batch-sharded ``sharded_cg``: per-instance solutions within 1e-10 of
    JAX's single-device ``cg`` and equal iteration counts (no reduction
    at all: the same loop on each rank's slice);
  * an instance-sharded diagonal system whose CG dot products go through
    the all-reduce: within 1e-10, equal iteration count;
  * a sharded ridge hypergradient (DTensors, a ``SolveSharding`` with the
    batch on the mesh) and a replicated-λ one (its per-shard products
    summed over the mesh) against JAX's single-device gradients, 1e-8;
  * the sharded ridge's Hessian (``torch.func.hessian`` and its ``vmap``
    over θ, plain tensors: the rules' products on global values, their
    solves on the ranks) and the replicated λ's, against JAX's, 1e-8;
  * ``pipeline_forward`` at S = world size against the sequential forward.

Spec construction needs no ranks: for every config of
``repro_torch/configs`` the port's ``params_specs`` on an abstract 16 × 16
and 2 × 16 × 16 mesh equal the reference's ``repro.distributed.sharding.
params_specs`` leaf for leaf (the reference's ``TestSpecConstruction``).
The mesh builders start a single-rank group only where no group runs and
``WORLD_SIZE`` is unset.
"""
import functools
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.core import linear_solve as jls
from repro.core import operators as jops
from repro.core.diff_api import ImplicitDiffSpec as JSpec
from repro.core.diff_api import implicit_diff as jimplicit
from repro.distributed import sharding as jshd
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.spec import P
from repro_torch.launch import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60
CHILD_TIMEOUT_S = 120
B, D_CG, N_DIAG, M_ROWS, D_RIDGE = 16, 24, 64, 12, 6
L_PIPE, M_PIPE, MB_PIPE, D_PIPE = 8, 8, 4, 16

# the code every rank runs: torch, numpy and repro_torch only
CHILD = textwrap.dedent("""
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    rank, world, init, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group(
        "gloo", init_method="file://" + init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=%(timeout)d))

    from repro_torch.core import linear_solve as ls, operators as ops
    from repro_torch.core.diff_api import ImplicitDiffSpec, implicit_diff
    from repro_torch.distributed import P, ShardedOperator, SolveSharding
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_solve_mesh

    D = {k: torch.tensor(v) for k, v in np.load(inp).items()}
    res = {}
    mesh = make_solve_mesh(device="cpu")
    assert mesh.size() == world

    # 1. batch-sharded CG: no reduction, each rank its slice
    op = ShardedOperator(ops.DenseOperator(D["A"], positive_definite=True),
                         mesh, P("data", None))
    x, info = ls.solve(op, distribute_tensor(D["b"], mesh, [Shard(0)]),
                       method="sharded_cg", tol=1e-10, return_info=True)
    assert x.to_local().shape[0] == D["b"].shape[0] // world
    res["cg_x"], res["cg_it"] = x.full_tensor(), info.iterations.full_tensor()
    res["cg_x_plain"] = ls.solve(op, D["b"], method="cg", tol=1e-10)

    # 2. instance-sharded diagonal system: the dots are all-reduced
    class Diag(ops.LinearOperator):
        def __init__(self, dg):
            super().__init__(torch.zeros_like(dg), positive_definite=True)
            self.dg = dg

        def matvec(self, v):
            return self.dg * v

    reduced = []
    op = ShardedOperator(Diag, mesh, P("data"), operands=(D["dg"],),
                         operand_specs=(P("data"),))
    base_reduce = op.reduce
    op.reduce = lambda s: (reduced.append(1), base_reduce(s))[1]
    x, info = ls.solve(op, D["db"], method="sharded_cg", tol=1e-10,
                       return_info=True)
    res["diag_x"], res["diag_it"] = x, info.iterations
    res["diag_reduced"] = torch.tensor(len(reduced))

    # 3. the sharded ridge hypergradient, on DTensors
    def F(x, theta, X, y):
        r = torch.einsum("bmd,bd->bm", X, x) - y
        return torch.einsum("bmd,bm->bd", X, r) + theta[:, None] * x

    def local_solver(theta, X, y):
        A = torch.einsum("bmd,bme->bde", X, X) + theta[:, None, None] \\
            * torch.eye(X.shape[-1], dtype=X.dtype)
        return torch.linalg.solve(
            A, torch.einsum("bmd,bm->bd", X, y)[..., None])[..., 0]

    def solver(init, theta, X, y):
        return DTensor.from_local(local_solver(
            theta.to_local(), X.to_local(), y.to_local()), mesh, [Shard(0)],
            run_check=False)

    sh = SolveSharding(mesh, P("data", None), batch_ndim=1,
                       theta_specs=(P("data"), P("data", None, None),
                                    P("data", None)))
    spec = ImplicitDiffSpec(optimality_fun=F, solve="cg", tol=1e-12,
                            sharding=sh)
    theta = distribute_tensor(D["theta"], mesh, [Shard(0)])
    theta.requires_grad_()
    Xs = distribute_tensor(D["X"], mesh, [Shard(0)])
    ys = distribute_tensor(D["y"], mesh, [Shard(0)])
    xs = implicit_diff(spec)(solver)(None, theta, Xs, ys)
    (g,) = torch.autograd.grad((xs ** 2).sum(), theta)
    assert g.placements == (Shard(0),)
    res["ridge_grad"] = g.full_tensor()

    # 3b. one λ for every instance: its products summed over the mesh
    def F_lam(x, lam, X, y):
        return F(x, lam * torch.ones(X.shape[0], dtype=X.dtype), X, y)

    sh_lam = SolveSharding(mesh, P("data", None), batch_ndim=1,
                           theta_specs=(P(), P("data", None, None),
                                        P("data", None)))
    lam = D["lam"].clone().requires_grad_()
    dec_lam = implicit_diff(ImplicitDiffSpec(
        optimality_fun=F_lam, solve="cg", tol=1e-12, sharding=sh_lam))(
        lambda init, lam, X, y: local_solver(
            lam * torch.ones(X.shape[0], dtype=X.dtype), X, y))
    (g,) = torch.autograd.grad((dec_lam(None, lam, D["X"], D["y"]) ** 2)
                               .sum(), lam)
    res["lam_grad"] = g

    # 4b. torch.func.vmap of a sharded solve (a batch of right-hand sides
    #     against one operator: one folded solve) and of a sharded
    #     gradient (over the cotangent seed, and over θ: one folded solve)
    op = ShardedOperator(ops.DenseOperator(D["A"], positive_definite=True),
                         mesh, P("data", None))
    res["vmap_x"] = torch.func.vmap(lambda bi: ls.solve(
        op, bi, method="sharded_cg", tol=1e-10))(D["bs"])
    dec = implicit_diff(spec)(lambda init, t, X, y: local_solver(t, X, y))
    grad = torch.func.grad(lambda t, s: (dec(None, t, D["X"], D["y"]) * s)
                           .sum())
    res["vmap_seed_grad"] = torch.func.vmap(grad, in_dims=(None, 0))(
        D["theta"], D["seeds"])
    res["vmap_theta_grad"] = torch.func.vmap(grad)(D["thetas"], D["seeds"])

    # 4c. second derivatives through the sharded solve (plain tensors)
    hess = torch.func.hessian(lambda t: (dec(None, t, D["X"], D["y"]) ** 2)
                              .sum())
    res["ridge_hessian"] = hess(D["theta"])
    res["vmap_ridge_hessian"] = torch.func.vmap(hess)(D["thetas"])
    res["lam_hessian"] = torch.func.hessian(lambda lam: (dec_lam(
        None, lam, D["X"], D["y"]) ** 2).sum())(D["lam"])

    # 4. the pipeline at S = world
    stages = make_solve_mesh(axis="stage", device="cpu")
    res["pipe"] = pipeline_forward(lambda w, h: torch.tanh(h @ w), D["W"],
                                   D["xs"], stages)

    if rank == 0:
        np.savez(out, **{k: v.detach().numpy() for k, v in res.items()})
    dist.destroy_process_group()
    print("OK", rank)
""") % {"timeout": GROUP_TIMEOUT_S}


def _spd(npr, n, d, shift):
    C = npr.randn(n, d, d) / np.sqrt(d)
    return np.einsum("bji,bjk->bik", C, C) + shift * np.eye(d)


def _inputs():
    npr = np.random.RandomState(0)
    return dict(
        A=_spd(npr, B, D_CG, 2.0), b=npr.randn(B, D_CG),
        dg=1.0 + npr.rand(N_DIAG), db=npr.randn(N_DIAG),
        X=npr.randn(B, M_ROWS, D_RIDGE), y=npr.randn(B, M_ROWS),
        theta=np.linspace(0.5, 2.0, B), lam=np.array(0.7),
        bs=npr.randn(3, B, D_CG), seeds=npr.randn(3, B, D_RIDGE),
        thetas=np.linspace(0.5, 2.0, B)[None] * np.array([[1.0], [1.5],
                                                           [2.0]]),
        W=0.3 * npr.randn(L_PIPE, D_PIPE, D_PIPE),
        xs=npr.randn(M_PIPE, MB_PIPE, D_PIPE))


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"{w}ranks")
def ranks(request, tmp_path_factory):
    """One launch of ``world`` ranks; the inputs and rank 0's results."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ranks{world}")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(world),
         str(tmp / "group"), str(tmp / "inputs.npz"), str(tmp / "out.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {r}" in out, err[-3000:]
    with np.load(tmp / "out.npz") as f:
        return world, inputs, dict(f)


def test_batch_sharded_cg_matches_single_device_jax(ranks):
    _, D, got = ranks
    x, info = jls.solve(jops.DenseOperator(jnp.asarray(D["A"]),
                                           positive_definite=True),
                        jnp.asarray(D["b"]), method="cg", tol=1e-10,
                        return_info=True)
    np.testing.assert_allclose(got["cg_x"], np.asarray(x), atol=1e-10)
    np.testing.assert_array_equal(got["cg_it"], np.asarray(info.iterations))
    # pure batch sharding runs each rank's slice through the one-device
    # loop: the plain-tensor call's gathered result is the same, bit for bit
    np.testing.assert_array_equal(got["cg_x_plain"], got["cg_x"])


def test_instance_sharded_dots_go_through_the_all_reduce(ranks):
    _, D, got = ranks

    class Diag(jops.LinearOperator):
        def __init__(self, dg):
            super().__init__(jnp.zeros_like(dg), positive_definite=True)
            self.dg = dg

        def matvec(self, v):
            return self.dg * v

    x, info = jls.solve(Diag(jnp.asarray(D["dg"])), jnp.asarray(D["db"]),
                        method="cg", tol=1e-10, return_info=True)
    np.testing.assert_allclose(got["diag_x"], np.asarray(x), atol=1e-10)
    assert int(got["diag_it"]) == int(info.iterations)
    # b's norm, r·z and r·r at entry, then p·Ap, r·r and r·z an iteration
    assert int(got["diag_reduced"]) == 3 + 3 * int(info.iterations)


def _jax_ridge_grad(D):
    def F(x, theta, X, y):
        r = jnp.einsum("bmd,bd->bm", X, x) - y
        return jnp.einsum("bmd,bm->bd", X, r) + theta[:, None] * x

    def solver(init, theta, X, y):
        A = jnp.einsum("bmd,bme->bde", X, X) \
            + theta[:, None, None] * jnp.eye(X.shape[-1])
        return jnp.linalg.solve(
            A, jnp.einsum("bmd,bm->bd", X, y)[..., None])[..., 0]

    dec = jimplicit(JSpec(optimality_fun=F, solve="cg", tol=1e-12))(solver)
    X, y = jnp.asarray(D["X"]), jnp.asarray(D["y"])
    g = jax.grad(lambda t: jnp.sum(dec(None, t, X, y) ** 2))(
        jnp.asarray(D["theta"]))
    g_lam = jax.grad(lambda lam: jnp.sum(dec(
        None, lam * jnp.ones(B), X, y) ** 2))(jnp.asarray(D["lam"]))
    return np.asarray(g), np.asarray(g_lam)


def test_sharded_ridge_hypergradient_matches_single_device_jax(ranks):
    _, D, got = ranks
    g, g_lam = _jax_ridge_grad(D)
    np.testing.assert_allclose(got["ridge_grad"], g, atol=1e-8)
    np.testing.assert_allclose(got["lam_grad"], g_lam, atol=1e-8)


def test_vmap_of_sharded_solves_matches_jax_vmap(ranks):
    """``torch.func.vmap`` of a sharded solve and of a sharded gradient on
    the ranks against ``jax.vmap`` of the single-device ones."""
    _, D, got = ranks
    A = jops.DenseOperator(jnp.asarray(D["A"]), positive_definite=True)
    want = jax.vmap(lambda bi: jls.solve(A, bi, method="cg", tol=1e-10))(
        jnp.asarray(D["bs"]))
    np.testing.assert_allclose(got["vmap_x"], np.asarray(want), atol=1e-10)

    def F(x, theta, X, y):
        r = jnp.einsum("bmd,bd->bm", X, x) - y
        return jnp.einsum("bmd,bm->bd", X, r) + theta[:, None] * x

    def solver(init, theta, X, y):
        A = jnp.einsum("bmd,bme->bde", X, X) \
            + theta[:, None, None] * jnp.eye(X.shape[-1])
        return jnp.linalg.solve(
            A, jnp.einsum("bmd,bm->bd", X, y)[..., None])[..., 0]

    dec = jimplicit(JSpec(optimality_fun=F, solve="cg", tol=1e-12))(solver)
    X, y = jnp.asarray(D["X"]), jnp.asarray(D["y"])
    grad = jax.grad(lambda t, s: jnp.sum(dec(None, t, X, y) * s))
    for key, axes, theta in (("vmap_seed_grad", (None, 0), D["theta"]),
                             ("vmap_theta_grad", (0, 0), D["thetas"])):
        want = jax.vmap(grad, in_axes=axes)(jnp.asarray(theta),
                                            jnp.asarray(D["seeds"]))
        np.testing.assert_allclose(got[key], np.asarray(want), atol=1e-8)


@functools.lru_cache(maxsize=None)
def _jax_ridge_hessians():
    """``jax.vmap(jax.hessian)`` of the ridge over ``thetas`` (whose first
    row is ``theta``) and the replicated λ's Hessian, on one device."""
    D = _inputs()

    def F(x, theta, X, y):
        r = jnp.einsum("bmd,bd->bm", X, x) - y
        return jnp.einsum("bmd,bm->bd", X, r) + theta[:, None] * x

    def solver(init, theta, X, y):
        A = jnp.einsum("bmd,bme->bde", X, X) \
            + theta[:, None, None] * jnp.eye(X.shape[-1])
        return jnp.linalg.solve(
            A, jnp.einsum("bmd,bm->bd", X, y)[..., None])[..., 0]

    dec = jimplicit(JSpec(optimality_fun=F, solve="cg", tol=1e-12))(solver)
    X, y = jnp.asarray(D["X"]), jnp.asarray(D["y"])
    hess = jax.jit(jax.vmap(jax.hessian(lambda t: jnp.sum(
        dec(None, t, X, y) ** 2))))(jnp.asarray(D["thetas"]))
    lam = jax.hessian(lambda lam: jnp.sum(dec(None, lam * jnp.ones(B), X,
                                              y) ** 2))(jnp.asarray(D["lam"]))
    return np.asarray(hess), np.asarray(lam)


def test_sharded_hessian_matches_single_device_jax(ranks):
    """``hessian`` of the sharded ridge, its ``vmap`` over θ and the
    replicated λ's on the ranks against ``jax.hessian`` on one device."""
    _, D, got = ranks
    hess, lam = _jax_ridge_hessians()
    assert np.array_equal(D["thetas"][0], D["theta"])
    np.testing.assert_allclose(got["ridge_hessian"], hess[0], atol=1e-8)
    np.testing.assert_allclose(got["vmap_ridge_hessian"], hess, atol=1e-8)
    np.testing.assert_allclose(got["lam_hessian"], lam, atol=1e-8)


def test_pipeline_forward_matches_the_sequential_forward(ranks):
    _, D, got = ranks

    def seq(h):
        for w in D["W"]:
            h = np.tanh(h @ w)
        return h

    want = np.stack([seq(D["xs"][i]) for i in range(M_PIPE)])
    np.testing.assert_allclose(got["pipe"], want, atol=1e-12)


# ---------------------------------------------------------------------------
# spec construction (no ranks)
# ---------------------------------------------------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model"), None),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), "pod")}


def _port_layout(tree):
    """The JAX parameter shapes in the port's layout: ``blocks`` a list of
    per-layer dicts, each leaf without the stacked L axis."""
    def shapes(t, strip):
        if isinstance(t, dict):
            return {k: shapes(v, strip) for k, v in t.items()}
        return types.SimpleNamespace(
            shape=tuple(t.shape)[1:] if strip else tuple(t.shape))

    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return types.SimpleNamespace(shape=tuple(t.shape)[1:])

    out = {}
    for k, v in tree.items():
        if k == "blocks":
            n = jax.tree_util.tree_leaves(v)[0].shape[0]
            out[k] = [layer(v, i) for i in range(n)]
        else:
            out[k] = shapes(v, False)
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", tconfigs.names())
def test_params_specs_equal_the_reference_leaf_for_leaf(arch, mesh_name):
    sizes, names, pod = MESHES[mesh_name]
    jparams = jmodel.init_params_abstract(jax.random.PRNGKey(0),
                                          jconfigs.get(arch))
    want = jshd.params_specs(jparams, jshd.ShardingRules(pod=pod),
                             jshd.abstract_mesh(sizes, names))
    got = tshd.params_specs(_port_layout(jparams),
                            tshd.ShardingRules(pod=pod),
                            tshd.abstract_mesh(sizes, names))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    n = 0
    for path, spec in flat:
        keys = [getattr(k, "key", None) for k in path]
        if keys[0] == "blocks":
            assert spec[0] is None, (keys, spec)
            node = got["blocks"]
            layers = node
            for layer_specs in layers:
                leaf = layer_specs
                for k in keys[1:]:
                    leaf = leaf[k]
                assert tuple(leaf) == tuple(spec)[1:], (keys, leaf, spec)
                n += 1
        else:
            leaf = got
            for k in keys:
                leaf = leaf[k]
            assert tuple(leaf) == tuple(spec), (keys, leaf, spec)
            n += 1
    assert n >= len(flat)


def test_port_parameters_take_the_layout_the_specs_assume():
    """Every decoder family's own ``init_params`` (smoke sizes, on the
    CPU) has the layout ``_port_layout`` builds from the JAX tree."""
    from repro_torch.models import model as tmodel
    for arch in ("qwen1.5-4b", "rwkv6-3b", "granite-moe-3b-a800m",
                 "deepseek-v2-236b", "zamba2-7b"):
        cfg = tconfigs.get(arch, smoke=True)
        params = tmodel.init_params(cfg, device="cpu")
        jparams = jmodel.init_params_abstract(jax.random.PRNGKey(0),
                                              jconfigs.get(arch, smoke=True))
        mesh = tshd.abstract_mesh((1, 16), ("data", "model"))
        rules = tshd.ShardingRules()
        assert tshd.params_specs(params, rules, mesh) == \
            tshd.params_specs(_port_layout(jparams), rules, mesh)


def test_rules_of_the_reference_spec_tests():
    mesh = tshd.abstract_mesh((1, 1), ("data", "model"))
    rules = tshd.ShardingRules()
    s = tshd.param_spec(("blocks", "attn", "w_q"), (256, 256), rules, mesh)
    assert s == P(None, "model") or s == P("data", "model")
    assert tshd.param_spec(("blocks", "attn", "w_o"), (256, 256), rules,
                           mesh)[0] == "model"
    assert tshd.param_spec(("embed", "tok"), (50304, 512), rules,
                           mesh) == P("model", None)
    assert tshd.param_spec(("embed", "unembed"), (512, 50304), rules,
                           mesh) == P(None, "model")
    assert tshd.param_spec(("blocks", "ln1", "scale"), (512,), rules,
                           mesh) == P()
    mesh = tshd.abstract_mesh((1, 16), ("data", "model"))
    s = tshd.param_spec(("blocks", "mlp", "w_gate"), (160, 5120, 1536),
                        rules, mesh)
    assert s[0] == "model"
    s = tshd.param_spec(("blocks", "mlp", "w_gate"), (40, 1536, 512), rules,
                        mesh)
    assert s[0] is None and "model" in s


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_activation_cache_and_decode_specs_equal_the_reference(
        mesh_name):
    sizes, names, pod = MESHES[mesh_name]
    jr, tr = jshd.ShardingRules(pod=pod), tshd.ShardingRules(pod=pod)
    jm, tm = jshd.abstract_mesh(sizes, names), tshd.abstract_mesh(sizes,
                                                                   names)
    assert tuple(tshd.batch_spec(tr)) == tuple(jshd.batch_spec(jr))
    assert tuple(tshd.activation_spec(tr)) == \
        tuple(jshd.activation_spec(jr))
    for arch in ("qwen1.5-4b", "llama3-405b", "rwkv6-3b"):
        jc, tc = jconfigs.get(arch), tconfigs.get(arch)
        for seq_shard in (False, True):
            assert tuple(tshd.kv_cache_spec(tr, tc, tm, 4, seq_shard)) == \
                tuple(jshd.kv_cache_spec(jr, jc, jm, 4, seq_shard))
            shapes = ((tc.num_layers, 32, 32768, tc.num_kv_heads, 128),
                      (tc.num_layers, 1, 524288, 8, 128), (40, 32, 2560))
            jspecs = jshd.decode_state_specs(
                tuple(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes),
                jr, jc, jm, seq_shard)
            tspecs = tshd.decode_state_specs(
                tuple(types.SimpleNamespace(shape=s) for s in shapes), tr,
                tc, tm, seq_shard)
            assert [tuple(s) for s in tspecs] == [tuple(s) for s in jspecs]


def test_named_binds_specs_as_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tshd.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    got = tshd.named(mesh, {"w": P("data", "model"), "b": P(),
                            "x": P(("pod", "data"), None)})
    assert got["w"] == (Replicate(), Shard(0), Shard(1))
    assert got["b"] == (Replicate(),) * 3
    assert got["x"] == (Shard(0), Shard(0), Replicate())


# ---------------------------------------------------------------------------
# the mesh builders and the process group
# ---------------------------------------------------------------------------

def test_make_solve_mesh_starts_a_single_rank_group_only_when_none_runs(
        monkeypatch):
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_solve_mesh(device="cpu")
    assert not dist.is_initialized()
    monkeypatch.delenv("WORLD_SIZE")
    try:
        mesh = tmesh.make_solve_mesh(device="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
        host = tmesh.make_host_mesh(1, 1, device="cpu")
        assert host.mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="requested 2 devices"):
            tmesh.make_solve_mesh(devices=2, device="cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            tmesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="needs 512 ranks"):
            tmesh.make_production_mesh(multi_pod=True, device="cpu")
        assert tmesh.auto_mesh_size(64, 16) == 1
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_solve_mesh()
        assert not dist.is_initialized()
