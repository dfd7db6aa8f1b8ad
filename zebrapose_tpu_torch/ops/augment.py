"""GDR-Net color augmentation of a batch of crops, on the device.

Port of `zebrapose_tpu/ops/augment.py`. The reference builds an imgaug
pipeline per sample on CPU workers (`zebrapose/GDR_Net_Augmentation.py:
161-178`, applied with color_aug_prob 0.8):

  [Sometimes(0.3, SaltAndPepper(0.05))]        (use_peper_salt)
  [Sometimes(0.2, MotionBlur(k=5))]            (use_motion_blur)
  Sometimes(0.4, CoarseDropout(p=0.1, size_percent=0.05))
  Sometimes(0.5, GaussianBlur(sigma ~ U(0,1)))
  Sometimes(0.5, Add(U(-20,20), per_channel 0.3))
  Sometimes(0.4, Invert(0.2, per_channel))
  Sometimes(0.5, Multiply(U(0.7,1.4), per_channel 0.8))
  Sometimes(0.5, Multiply(U(0.7,1.4)))
  Sometimes(0.5, LinearContrast(U(0.5,2.0), per_channel 0.3))

The random values and the arithmetic are apart: `draw_augment` fills an
`AugmentDraws` record for the whole batch from a `torch.Generator`, and
`augment_batch` applies it with batched tensor ops (no loop over
samples). Tests inject the JAX package's
draws through the record. As in JAX, every op is computed for every
sample and its gate selects the result. Like the JAX package (and unlike
the reference) the 256² crop is augmented, not the full frame.

Images are float32 [N, H, W, 3] in [0, 255] (BGR).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

COLOR_AUG_PROB = 0.8
_OPS = ("dropout", "blur", "add", "invert", "mul_pc", "mul", "contrast")
_GATE_P = {"pepper": 0.3, "motion": 0.2, "dropout": 0.4, "blur": 0.5,
           "add": 0.5, "invert": 0.4, "mul_pc": 0.5, "mul": 0.5,
           "contrast": 0.5}


def dropout_grid(h: int, w: int, size_percent: float = 0.05):
    """Cells of the coarse-dropout grid: round(side * 0.05), at least 1
    (13 for 256)."""
    return (max(int(round(h * size_percent)), 1),
            max(int(round(w * size_percent)), 1))


@dataclasses.dataclass
class AugmentDraws:
    """Every random value of one batch of n crops.

    `sample` [n] bool is the 0.8 gate of the whole recipe; `apply` maps
    each op to its [n] bool gate. Op parameters: `hit`, `salt` [n,h,w]
    bool (salt and pepper; None unless enabled), `angle` [n] (motion
    blur; None unless enabled), `drop` [n,gh,gw] bool (coarse dropout),
    `sigma` [n] (Gaussian blur, before its 1e-3 floor), `add`, `mul_pc`,
    `mul`, `contrast` [n,3] (per-channel values or one shared value
    repeated, as each sample's per-channel draw chose) and `flips` [n,3]
    bool (invert)."""

    sample: torch.Tensor
    apply: dict
    drop: torch.Tensor
    sigma: torch.Tensor
    add: torch.Tensor
    flips: torch.Tensor
    mul_pc: torch.Tensor
    mul: torch.Tensor
    contrast: torch.Tensor
    hit: Optional[torch.Tensor] = None
    salt: Optional[torch.Tensor] = None
    angle: Optional[torch.Tensor] = None

    def to(self, device) -> "AugmentDraws":
        def mv(v):
            if isinstance(v, dict):
                return {k: mv(x) for k, x in v.items()}
            return None if v is None else v.to(device)
        return AugmentDraws(**{f.name: mv(getattr(self, f.name))
                               for f in dataclasses.fields(self)})


def draw_augment(generator: torch.Generator, n: int, h: int, w: int,
                 use_pepper_salt: bool = False,
                 use_motion_blur: bool = False) -> AugmentDraws:
    """Draw the augmentation of a batch of n [h, w] crops on the
    generator's device."""
    dev = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def uniform(low, high, *shape):
        return low + (high - low) * u(*shape)

    def per_channel(p, low, high):
        per, shared = uniform(low, high, n, 3), uniform(low, high, n, 1)
        return torch.where(u(n, 1) < p, per, shared.expand(n, 3))

    ops = (("pepper",) if use_pepper_salt else ()) + \
        (("motion",) if use_motion_blur else ()) + _OPS
    extra = {}
    if use_pepper_salt:
        extra.update(hit=u(n, h, w) < 0.05, salt=u(n, h, w) < 0.5)
    if use_motion_blur:
        extra["angle"] = uniform(0.0, math.pi, n)
    return AugmentDraws(
        sample=u(n) < COLOR_AUG_PROB,
        apply={op: u(n) < _GATE_P[op] for op in ops},
        drop=u(n, *dropout_grid(h, w)) < 0.1,
        sigma=u(n),
        add=per_channel(0.3, -20.0, 20.0),
        flips=u(n, 3) < 0.2,
        mul_pc=per_channel(0.8, 0.7, 1.4),
        mul=per_channel(0.0, 0.7, 1.4),
        contrast=per_channel(0.3, 0.5, 2.0),
        **extra)


def _clip(img):
    return torch.clamp(img, 0.0, 255.0)


def _chan(v):
    """[n, 3] -> broadcast over [n, h, w, 3]."""
    return v[:, None, None, :]


def salt_and_pepper(img, hit, salt):
    noise = torch.where(salt, 255.0, 0.0)[..., None]
    return torch.where(hit[..., None], noise, img)


def coarse_dropout(img, drop):
    n, h, w, _ = img.shape
    gh, gw = drop.shape[1:]
    ys = (torch.arange(h, device=img.device) * gh // h).clamp(0, gh - 1)
    xs = (torch.arange(w, device=img.device) * gw // w).clamp(0, gw - 1)
    full = drop[:, ys][:, :, xs]
    return torch.where(full[..., None], 0.0, img)


def _correlate(img, kern, mode):
    """Cross-correlate every channel of sample i with kern[i] ([n, kh,
    kw], odd sides) over img [n, h, w, c], padded by `mode` ("replicate"
    or zeros): a sum of shifted copies in JAX's order of terms, in
    float32 (no TF32 convolution on the card)."""
    n, h, w, _ = img.shape
    kh, kw = kern.shape[1:]
    x = F.pad(img.permute(0, 3, 1, 2),
              (kw // 2, kw // 2, kh // 2, kh // 2),
              mode=mode).permute(0, 2, 3, 1)
    out = 0
    for i in range(kh):
        for j in range(kw):
            out = out + kern[:, i, j, None, None, None] * \
                x[:, i:i + h, j:j + w]
    return out


def gaussian_blur(img, sigma, radius=3):
    """Separable blur (H, then W) with edge padding, per-sample sigma."""
    sigma = torch.clamp(sigma, min=1e-3)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-0.5 * (x[None] / sigma[:, None]) ** 2)
    k = k / k.sum(-1, keepdim=True)
    rows = _correlate(img, k[:, :, None], "replicate")
    return _correlate(rows, k[:, None, :], "replicate")


def motion_kernel(angle, k=5):
    """[n, k, k] line kernels through the center at `angle` (not
    flipped: both stacks cross-correlate)."""
    r = k // 2
    yy = (torch.arange(k, dtype=torch.float32, device=angle.device)
          - r)[:, None].expand(k, k)
    xx = yy.T
    s, c = torch.sin(angle)[:, None, None], torch.cos(angle)[:, None, None]
    d = torch.abs(-s * xx + c * yy)
    along = torch.abs(c * xx + s * yy)
    kern = ((d < 0.5) & (along <= r + 0.5)).to(torch.float32)
    return kern / torch.clamp(kern.sum((1, 2), keepdim=True), min=1.0)


def motion_blur(img, angle, k=5):
    """Zero 'SAME' padding."""
    return _correlate(img, motion_kernel(angle, k), "constant")


def augment_batch(images: torch.Tensor, draws: AugmentDraws
                  ) -> torch.Tensor:
    """Apply the recipe of `draws` to images [n, h, w, 3] f32 in [0,
    255] (same device)."""
    img = images

    def gate(op, out):
        return torch.where(draws.apply[op][:, None, None, None], out, img)

    if "pepper" in draws.apply:
        img = gate("pepper", salt_and_pepper(img, draws.hit, draws.salt))
    if "motion" in draws.apply:
        img = gate("motion", motion_blur(img, draws.angle))
    img = gate("dropout", coarse_dropout(img, draws.drop))
    img = gate("blur", gaussian_blur(img, draws.sigma))
    img = gate("add", _clip(img + _chan(draws.add)))
    img = gate("invert", torch.where(_chan(draws.flips), 255.0 - img, img))
    img = gate("mul_pc", _clip(img * _chan(draws.mul_pc)))
    img = gate("mul", _clip(img * _chan(draws.mul)))
    img = gate("contrast", _clip(127.0 + _chan(draws.contrast)
                                 * (img - 127.0)))
    return torch.where(draws.sample[:, None, None, None], _clip(img),
                       images)
