"""``eager.ms_per_step``: device milliseconds a step of every device
operation that is neither a matrix product nor a kernel of the port
(elementwise, reductions, indexing, copies)."""


def read(run):
    t = run.trace
    if t.steps == 0:
        return None
    s = sum(sec for name, (sec, _) in t.kernels.items()
            if not t.is_product(name) and t.library_of(name) is None)
    return 1e3 * s / t.steps if s > 0 else None
