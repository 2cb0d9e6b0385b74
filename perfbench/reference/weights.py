"""Seeded random weights, drawn on a device in a few large calls.

Every tensor that is neither a bias (zeros) nor a norm scale (ones) is a
view of one flat normal draw of a ``torch.Generator`` on the device,
scaled in place: embedding tables by 1, every other weight by fan_in^-1/2, so activations keep their size through the depth
as in a trained model. The same seed gives the same tensors, so the
reference can draw its own copy after the system under test is gone.
"""

from __future__ import annotations

import math

import torch


def init_std(name: str, shape: tuple) -> float | None:
    """None for a bias (zeros); 0.0 for a norm scale (ones); else the std."""
    if name.endswith(".bias"):
        return None
    if len(shape) == 1:
        return 0.0
    if "embedding" in name:
        return 1.0
    return math.prod(shape[1:]) ** -0.5


def part_seed(seed: int, part: int) -> int:
    return (int(seed) * 1_000_003 + part) % 2 ** 63


def draw(shapes: dict, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    """{name: shape} -> {name: tensor} on ``device`` in ``dtype``."""
    device = torch.device(device)
    stds = {k: init_std(k, s) for k, s in shapes.items()}
    total = sum(math.prod(s) for k, s in shapes.items() if stds[k])
    if device.type == "meta":
        return {k: torch.empty(s, device=device, dtype=dtype) for k, s in shapes.items()}
    gen = torch.Generator(device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for k, shape in shapes.items():
        std = stds[k]
        if std is None:
            out[k] = torch.zeros(shape, device=device, dtype=dtype)
        elif std == 0.0:
            out[k] = torch.ones(shape, device=device, dtype=dtype)
        else:
            n = math.prod(shape)
            out[k] = flat[at:at + n].view(shape).mul_(std)
            at += n
    return out
