"""``matmul.ms_per_step``: device milliseconds a step of the matrix-product
kernels (cuBLAS / CUTLASS by name; none of the port's own kernels)."""


def read(run):
    t = run.trace
    if t.steps == 0:
        return None
    s = sum(sec for name, (sec, _) in t.kernels.items()
            if t.is_product(name))
    return 1e3 * s / t.steps if s > 0 else None
