"""Published peaks of the chips the benchmark runs on, by the name that
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM part,
dense rates without sparsity, at the full power limit of 700 W)."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(kind: str):
    """The peaks of the chip named ``kind``, or None for another."""
    return PEAKS.get(kind)
