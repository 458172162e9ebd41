"""``rwkv_wkv_roofline``: the port's WKV-6 kernel's share of its roofline,
the least time the card could take for one launch at the cell's shape over
the kernel's mean device time a launch.

One launch: r, k, v (B, T, H, N) bf16, w (B, T, H, N) float32, u (H, N)
float32, the output (B, T, H, N) bf16 and the final state (B, H, N, N)
float32.  Operations: 5·N² a head and step (2N² for o, 3N² for S) at the
float32 peak.  Bytes: each input read once, each output written once."""

LIBRARY = "rwkv_wkv"


def bound(B, T, H, N, peaks):
    """(seconds, FLOPs, bytes) of one launch."""
    n = B * T * H * N
    flops = 5.0 * N * N * B * T * H
    nbytes = n * (3 * 2 + 4 + 2) + H * N * 4 + B * H * N * N * 4
    return (max(flops / peaks["f32_flops"],
                nbytes / peaks["hbm_bytes_per_s"]), flops, nbytes)


def read(run):
    sec, n = run.trace.launches(LIBRARY)
    if run.peaks is None or n == 0:
        return None
    c, tr = run.config, run.traffic
    N = c["head_size"]
    b, _, _ = bound(tr["batch"], tr["prompt_len"], c["hidden_size"] // N, N,
                    run.peaks)
    return 100.0 * b / (sec / n)
