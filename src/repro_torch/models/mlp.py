"""SwiGLU feed-forward (the port of ``repro.models.mlp``).

Under a step whose rules split ``ff`` over ``"model"`` the layer is
Megatron's: ``w_gate`` and ``w_up`` column-parallel on the rank's ff
slice, ``w_down`` row-parallel with its partial outputs summed over
``"model"``."""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.common import dense_init, silu


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), ("embed", "ff")),
        "w_up": dense_init(gen, (d_model, d_ff), ("embed", "ff")),
        "w_down": dense_init(gen, (d_ff, d_model), ("ff", "embed"),
                             fan_in=d_ff),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    ff = params["w_gate"].shape[-1]
    split = common.model_split("ff", ff)
    if split:
        x = common.enter_tp(x)
    col = 1 if split else None
    gate = x @ common.tp_weight(params["w_gate"], col)
    up = x @ common.tp_weight(params["w_up"], col)
    h = common.shard(silu(gate) * up, ("batch", "seq", "ff"), ff=ff)
    y = h @ common.tp_weight(params["w_down"], 0 if split else None)
    return common.leave_tp(y) if split else y
