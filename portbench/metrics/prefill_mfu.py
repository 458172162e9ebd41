"""``prefill_mfu``: the whole prefill step's share of the card's bf16
dense peak.  Model FLOPs (the reference family's ``step_flops``: what the
port's equations need for the step's tokens, experts at top-k) ÷ (the
traced window's seconds per step × the peak)."""


def read(run):
    t = run.trace
    if run.peaks is None or t.steps == 0 or t.busy_s == 0:
        return None
    flops = run.reference.step_flops(run.config, run.traffic["batch"],
                                     run.traffic["prompt_len"])
    return 100.0 * flops / (t.window_s / t.steps * run.peaks["bf16_flops"])
