"""``mla_attention_roofline``: the port's MLA prefill kernel's share of its
roofline, the least time the card could take for one launch at the cell's
shape over the kernel's mean device time a launch.

One launch: q_nope (B, S, H, dn), q_rope (B, S, H, dr), k_nope and v
(B, S, H, dn / dv), the shared rope key (B, S, dr) and the output
(B, S, H, dv), bf16, causal.  Operations: 2·(dn + dr + dv) per head and
pair of a query and a key at or before it (QKᵀ at width dn + dr and PV at
width dv), at the bf16 dense peak.  Bytes: the five inputs read once and
the output written once, at the HBM peak.  None in a cell without the
kernel's launches."""

LIBRARY = "mla_attention"


def bound(B, S, H, dn, dr, dv, peaks, elem_bytes=2):
    """(seconds, FLOPs, bytes) of one causal launch."""
    flops = 2.0 * (dn + dr + dv) * B * H * S * (S + 1) / 2
    nbytes = elem_bytes * B * S * (H * (dn + dr) + H * dn + dr + 2 * H * dv)
    return (max(flops / peaks["bf16_flops"],
                nbytes / peaks["hbm_bytes_per_s"]), flops, nbytes)


def read(run):
    sec, n = run.trace.launches(LIBRARY)
    if run.peaks is None or n == 0:
        return None
    c, tr = run.config, run.traffic
    b, _, _ = bound(tr["batch"], tr["prompt_len"], c["num_attention_heads"],
                    c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"], run.peaks)
    return 100.0 * b / (sec / n)
