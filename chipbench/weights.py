"""The model's weights, drawn by the benchmark from the seed.

Each group of ``reference.weight_groups`` (the embeddings and head, then
one group a layer) comes from one ``torch.randn`` call on the device, in
the dtype it is served in, from a generator seeded with the run's seed and
the group's index. So any group can be drawn again, alone and to the
bit, after the program has been freed: the reference never reads a weight
the program holds.
"""
from __future__ import annotations

import hashlib
import math

import torch


def stream_seed(seed: int, *names) -> int:
    """A 63-bit seed for one stream of the run: ``seed`` and ``names``
    hashed, so streams never overlap and any ``seed`` fits."""
    text = ":".join(str(n) for n in (seed, *names)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def draw(seed: int, index: int, specs: list, device, dtype) -> dict:
    """{name: tensor} of one group: one draw of all its elements, each
    tensor a view scaled by its ``init``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "weights", index))
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out = {}
    for (name, shape, init, fan_in), part in zip(specs, flat.split(sizes)):
        t = part.view(shape)
        if init == "embed":
            t.mul_(0.02)
        elif init == "dense":
            t.mul_(1.0 / math.sqrt(fan_in))
        elif init == "norm":
            t.mul_(0.1).add_(1.0)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
        out[name] = t
    return out


class Weights:
    """The benchmark's weights of one configuration and seed, drawn group
    by group on demand (``weights_of`` of the reference)."""

    def __init__(self, groups: list, seed: int, device, dtype):
        self.groups = groups
        self.index = {g: i for i, (g, _) in enumerate(groups)}
        self.seed, self.device, self.dtype = seed, device, dtype

    def __call__(self, group: str) -> dict:
        i = self.index[group]
        return draw(self.seed, i, self.groups[i][1], self.device, self.dtype)

    def load_into(self, model: torch.nn.Module) -> int:
        """Overwrite every parameter of the engine's ``model`` with these
        weights (``group.name`` is the parameter's name), group by group.
        Raises unless every parameter is written once, at its shape.
        Returns the count of elements written."""
        params = dict(model.named_parameters())
        written = 0
        with torch.no_grad():
            for group, _ in self.groups:
                for name, t in self(group).items():
                    p = params.pop(f"{group}.{name}", None)
                    if p is None or tuple(p.shape) != tuple(t.shape):
                        raise ValueError(
                            f"{group}.{name} {tuple(t.shape)}: the engine "
                            f"has {None if p is None else tuple(p.shape)}")
                    p.copy_(t)
                    written += t.numel()
        if params:
            raise ValueError(f"engine parameters left undrawn: {sorted(params)}")
        return written
