"""repro_torch.core — automatic implicit differentiation in PyTorch.

Counterpart of ``repro.core``, restricted to what this port covers so far:

  linear operators (``repro_torch.core.operators``):
    LinearOperator, FunctionOperator, JacobianOperator, DenseOperator,
    TransposedOperator, RidgeShifted, as_operator, jacobi_preconditioner,
    jacobi_preconditioner_from
  implicit-diff API (one wrapper serves reverse and forward mode):
    ImplicitDiffSpec, implicit_diff      — repro_torch.core.diff_api
    custom_root, custom_fixed_point, custom_root_jvp,
    custom_fixed_point_jvp, root_vjp, root_jvp
                                         — repro_torch.core.implicit_diff
  linear-solve engine (``repro_torch.core.linear_solve``):
    solve, route_solve, solve_cg / normal_cg / dense_gmres / lu /
    pallas_cg, SolverSpec registry, SolveInfo

The solver runtime, optimality/projection/prox catalogs, bilevel driver
and DEQ layer are not ported yet (ROADMAP queue A).

Note: ``repro_torch.core.implicit_diff`` the *submodule* is shadowed in
this namespace by ``implicit_diff`` the *function*.
"""
from repro_torch.core.operators import (LinearOperator, FunctionOperator,
                                        JacobianOperator, DenseOperator,
                                        TransposedOperator, RidgeShifted,
                                        as_operator, jacobi_preconditioner,
                                        jacobi_preconditioner_from)
from repro_torch.core.implicit_diff import (custom_root, custom_fixed_point,
                                            custom_root_jvp,
                                            custom_fixed_point_jvp,
                                            root_vjp, root_jvp)
from repro_torch.core.linear_solve import (solve, route_solve, solve_cg,
                                           solve_dense_gmres,
                                           solve_normal_cg, solve_lu,
                                           solve_pallas_cg, SolverSpec,
                                           SolveInfo, register_solver,
                                           get_solver, get_spec,
                                           available_solvers)
# imported last: the ``implicit_diff`` FUNCTION shadows the submodule name
from repro_torch.core.diff_api import ImplicitDiffSpec, implicit_diff
