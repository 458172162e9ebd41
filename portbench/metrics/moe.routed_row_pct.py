"""``moe.routed_row_pct``: the share of the rows the MoE layer's expert
products run that the router assigned, 100 × routed ÷ computed, from the
program's counter ``moe_expert_rows_total`` (``repro_torch.models.moe``).

The program counts on the host, from shapes alone, and only while tracing
is on (a profiler records or a tracer is installed), so in a traced run
the process's counter holds the traced window's steps.  Dense dispatch
runs every expert on every token: 100·k/E.  None without the counter (a
program that lacks it, a model without MoE) or without traced device
work."""

COUNTER = "moe_expert_rows_total"


def read(run):
    if run.trace.busy_s == 0:
        return None
    from repro_torch.observability.metrics import global_registry
    rows = global_registry().snapshot().get(COUNTER)
    if rows is None:
        return None
    computed = rows["values"].get('kind="computed"', 0.0)
    routed = rows["values"].get('kind="routed"', 0.0)
    return 100.0 * routed / computed if computed > 0 else None
