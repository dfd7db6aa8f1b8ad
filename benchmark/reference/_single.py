"""What the frozen copies import from the port's `parallel/mesh.py` and
`utils/device.py`, for one process: the reference never runs across
ranks."""

from __future__ import annotations

import torch


class World:
    """A world of one process (the copies only ask `distributed`)."""

    distributed = False


def all_reduce_(tensors, world) -> None:
    raise RuntimeError("the reference runs in one process")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    raise RuntimeError("the reference runs in one process")


def resolve_device(device=None, *tensors) -> torch.device:
    """`device` when given, else that of the first tensor, else the
    CPU."""
    if device is not None:
        return torch.device(device)
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")
