"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the full 700 W power limit).  A share is stated against these,
with the card's power limit beside it."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100": dict(bf16_flops=989e12, tf32_flops=495e12, f32_flops=67e12,
                        hbm_bytes_per_s=3.35e12, memory_bytes=80e9),
}


def peaks_for(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``)."""
    for prefix, p in PEAKS.items():
        if kind.startswith(prefix):
            return p
    raise KeyError(f"no published peaks for {kind!r}")
