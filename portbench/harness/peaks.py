"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates, at the full 700 W power limit)."""
from __future__ import annotations

PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12,
             "hbm_bytes_per_s": 3.35e12},
}


def peaks_of(kind: str):
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card the table does not hold."""
    for key, peaks in PEAKS.items():
        if key in (kind or ""):
            return peaks
    return None
