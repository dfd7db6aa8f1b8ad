"""Surface-code codec: RGB label <-> class id <-> base-d code planes.

Port of `zebrapose_tpu/codec/surface_code.py`: ids are stored in label
pixel colors as id = ch0<<16 | ch1<<8 | ch2 (cv2 BGR order), and code
planes put the digit axis last, most significant digit first. All
functions accept leading batch dimensions.
"""

from __future__ import annotations

import math

import torch


def rgb_to_class_id(bgr_image: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] BGR label image -> [..., H, W] int32 class id."""
    img = bgr_image.to(torch.int32)
    return (img[..., 0] << 16) + (img[..., 1] << 8) + img[..., 2]


def class_id_to_rgb(class_id: torch.Tensor) -> torch.Tensor:
    """[...] int class id -> [..., 3] BGR uint8 (inverse of above)."""
    cid = class_id.to(torch.int32)
    return torch.stack([(cid >> 16) & 0xFF, (cid >> 8) & 0xFF, cid & 0xFF],
                       dim=-1).to(torch.uint8)


def _bit_step(base: int) -> int:
    bit_step = int(math.log2(base))
    if (1 << bit_step) != base:
        raise ValueError(f"base must be a power of 2, got {base}")
    return bit_step


def class_id_to_code(class_id: torch.Tensor, base: int = 2,
                     n_digits: int = 16,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[...] int class id -> [..., n_digits] base-`base` digits, MSD
    first. `base` must be a power of two."""
    bit_step = _bit_step(base)
    shifts = torch.arange(n_digits - 1, -1, -1, dtype=torch.int32,
                          device=class_id.device) * bit_step
    digits = (class_id.to(torch.int32)[..., None] >> shifts) & (base - 1)
    return digits.to(dtype)


def code_to_class_id(code: torch.Tensor, base: int = 2) -> torch.Tensor:
    """[..., n_digits] digits (MSD first) -> [...] int32 class id.

    A float32 dot with powers of `base` (exact below 2^24, as in the JAX
    codec); wider codes accumulate in int64.
    """
    n = code.shape[-1]
    if _bit_step(base) * n <= 24:
        weights = float(base) ** torch.arange(
            n - 1, -1, -1, dtype=torch.float32, device=code.device)
        return (code.to(torch.float32) @ weights).to(torch.int32)
    iweights = base ** torch.arange(n - 1, -1, -1, dtype=torch.int64,
                                    device=code.device)
    return (code.to(torch.int64) * iweights).sum(-1).to(torch.int32)
