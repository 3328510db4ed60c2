"""SwiGLU feed-forward (the port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init, silu


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), ("embed", "ff")),
        "w_up": dense_init(gen, (d_model, d_ff), ("embed", "ff")),
        "w_down": dense_init(gen, (d_ff, d_model), ("ff", "embed"),
                             fan_in=d_ff),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    return (silu(gate) * up) @ params["w_down"]
