"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates, at the full power limit)."""

from __future__ import annotations

#: card name as torch.cuda.get_device_name gives it -> peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12),
}


def peaks(device_name: str) -> dict | None:
    """The peaks of the card named `device_name`, or None for a card this
    table does not hold."""
    return PEAKS.get(device_name)
