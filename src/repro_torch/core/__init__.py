"""repro_torch.core — automatic implicit differentiation in PyTorch.

Counterpart of ``repro.core``, restricted to what this port covers so far:

  linear operators (``repro_torch.core.operators``):
    LinearOperator, FunctionOperator, JacobianOperator,
    SampledJacobianOperator, DenseOperator, TransposedOperator,
    RidgeShifted, BlockDiagonal, ComposedOperator, as_operator,
    jacobi_preconditioner, jacobi_preconditioner_from
  implicit-diff API (one wrapper serves reverse and forward mode):
    ImplicitDiffSpec, implicit_diff      — repro_torch.core.diff_api
    custom_root, custom_fixed_point, custom_root_jvp,
    custom_fixed_point_jvp, root_vjp, root_jvp
                                         — repro_torch.core.implicit_diff
  linear-solve engine (``repro_torch.core.linear_solve``):
    solve, route_solve, solve_cg / normal_cg / bicgstab / gmres /
    dense_gmres / lu / neumann / pallas_cg, SolverSpec registry, SolveInfo
  solver runtime (state-based, auto implicit diff, run(mode=...)):
    IterativeSolver protocol, OptInfo diagnostics, and the solver classes
    GradientDescent, ProximalGradient, ProjectedGradient, MirrorDescent,
    BlockCoordinateDescent, Newton, LBFGS, FixedPointIteration,
    AndersonAcceleration    — repro_torch.core.solver_runtime
  optimality-condition catalog — repro_torch.core.optimality
  projections / prox catalogs  — repro_torch.core.projections, .prox
  legacy functional solvers    — repro_torch.core.solvers (deprecated shims)
  bilevel driver               — repro_torch.core.bilevel
  DEQ implicit layer: deq_fixed_point, make_deq_block, make_deq_solver
                               — repro_torch.core.implicit_layer

Note: ``repro_torch.core.implicit_diff`` the *submodule* is shadowed in
this namespace by ``implicit_diff`` the *function*.
"""
from repro_torch.core.operators import (LinearOperator, FunctionOperator,
                                        JacobianOperator,
                                        SampledJacobianOperator,
                                        DenseOperator, TransposedOperator,
                                        RidgeShifted, BlockDiagonal,
                                        ComposedOperator, as_operator,
                                        jacobi_preconditioner,
                                        jacobi_preconditioner_from)
from repro_torch.core.implicit_diff import (custom_root, custom_fixed_point,
                                            custom_root_jvp,
                                            custom_fixed_point_jvp,
                                            root_vjp, root_jvp)
from repro_torch.core.linear_solve import (solve, route_solve, solve_cg,
                                           solve_bicgstab, solve_gmres,
                                           solve_dense_gmres,
                                           solve_normal_cg, solve_lu,
                                           solve_neumann,
                                           solve_pallas_cg, SolverSpec,
                                           SolveInfo, register_solver,
                                           get_solver, get_spec,
                                           available_solvers)
from repro_torch.core.solver_runtime import (IterativeSolver, OptInfo,
                                             GradientDescent,
                                             ProximalGradient,
                                             ProjectedGradient, MirrorDescent,
                                             BlockCoordinateDescent, Newton,
                                             LBFGS, FixedPointIteration,
                                             AndersonAcceleration)
from repro_torch.core import optimality, projections, prox, solvers, bilevel
from repro_torch.core.implicit_layer import (deq_fixed_point, make_deq_block,
                                             make_deq_solver)
# imported last: the ``implicit_diff`` FUNCTION shadows the submodule name
from repro_torch.core.diff_api import ImplicitDiffSpec, implicit_diff
