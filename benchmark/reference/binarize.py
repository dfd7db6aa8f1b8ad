"""Network-output binarization on the device.

Port of `zebrapose_tpu/ops/binarize.py`. Layout NHWC, channel/bit axis
last. Logits are expected in float32 (the eval step casts bf16 network
outputs up before calling these).
"""

from __future__ import annotations

import torch


def mask_from_logits(mask_logits: torch.Tensor,
                     threshold: float = 0.5) -> torch.Tensor:
    """sigmoid + threshold -> {0, 1} float32 mask."""
    p = torch.sigmoid(mask_logits)
    return (p > threshold).to(torch.float32)


def code_from_logits(code_logits: torch.Tensor, loss_type: str = "BCE",
                     threshold: float = 0.5, base: int = 2) -> torch.Tensor:
    """Logits [..., H, W, C] -> hard base-d code planes.

    BCE/L1: per-plane sigmoid threshold. CE: the channel axis holds
    n_digits groups of `base` logits; argmax within each group.
    """
    if loss_type in ("BCE", "L1"):
        return (torch.sigmoid(code_logits) > threshold).to(torch.float32)
    if loss_type == "CE":
        shape = code_logits.shape
        grouped = code_logits.reshape(shape[:-1] + (shape[-1] // base, base))
        return torch.argmax(grouped, dim=-1).to(torch.float32)
    raise NotImplementedError(f"unknown loss type: {loss_type}")


def split_batch_sizes(second_dataset_ratio: float, batch_size: int):
    """Mixed real / PBR batch split (reference common_ops.get_batch_size;
    JAX `ops/binarize.py::split_batch_sizes`): (first, second)."""
    batch_2 = int(batch_size * second_dataset_ratio)
    return batch_size - batch_2, batch_2
