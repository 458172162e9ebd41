"""``flash_attention_roofline``: the port's flash-attention kernel's share
of its roofline, the least time the card could take for one launch at the
cell's shape over the kernel's mean device time a launch.

One launch: q and the output (B, S, H, D), k and v (B, S, Hkv, D), bf16,
causal.  Operations: 4·D per pair of a query and a key at or before it,
per head (QKᵀ and PV), at the bf16 dense peak.  Bytes: q, k, v read once
and the output written once, at the HBM peak."""

LIBRARY = "flash_attention"


def bound(B, S, H, Hkv, D, peaks, elem_bytes=2):
    """(seconds, FLOPs, bytes) of one causal launch."""
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = elem_bytes * (2 * B * S * H * D + 2 * B * S * Hkv * D)
    return (max(flops / peaks["bf16_flops"],
                nbytes / peaks["hbm_bytes_per_s"]), flops, nbytes)


def read(run):
    sec, n = run.trace.launches(LIBRARY)
    if run.peaks is None or n == 0:
        return None
    c, tr = run.config, run.traffic
    b, _, _ = bound(tr["batch"], tr["prompt_len"], c["num_attention_heads"],
                    c["num_key_value_heads"], c["head_dim"], run.peaks)
    return 100.0 * b / (sec / n)
