"""Device resolution shared by the entry points.

The port runs on CUDA. CPU execution is for tests and reference runs and
has to be asked for: an explicit `device="cpu"` or CPU tensors. Nothing
here falls back to the CPU when CUDA is missing. Under torchrun (one
process a card, `parallel/mesh.py`) a CUDA device without an index is
the rank's card, cuda:LOCAL_RANK.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None,
                   *tensors) -> torch.device:
    """The device an entry point runs on.

    An explicit `device` wins; otherwise the device of the first torch
    tensor among `tensors`; otherwise CUDA, which must be available.
    "cuda" without an index is cuda:LOCAL_RANK when torchrun set
    LOCAL_RANK.
    """
    if device is not None:
        dev = torch.device(device)
    else:
        dev = next((t.device for t in tensors
                    if isinstance(t, torch.Tensor)), None)
        if dev is None:
            dev = torch.device("cuda")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in \
            os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or CPU tensors) "
            "to run on the CPU")
    return dev
