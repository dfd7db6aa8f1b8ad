"""Loss stack: mask L1, binary-code losses, histogram-weighted curriculum.

Port of `zebrapose_tpu/models/losses.py`. The bit-error histogram EMA
(Python module state in the reference, BinaryCodeNet.py:32) is explicit
data: the train step passes it in and gets the new one back.

Layout: NHWC; code planes [N, H, W, n_bits]; masks [N, H, W] or
[N, H, W, 1] logits.

Reference semantics (`zebrapose/model/BinaryCodeNet.py`):
  * MaskLoss = L1(sigmoid(logits), gt)                        (:84-93)
  * Hamming histogram h_b = sum(|hard_code - gt| * hard_mask)
      / (sum(hard_mask) + 1), per bit                         (:96-109)
  * EMA: hist <- 0.95 * hist + 0.05 * hist_new                (:38-41)
  * bin_weights = exp(3 * min(hist, 0.51 - hist))             (:43-45)
  * weighted BCE: per-bit mean over batch/pixels, then weighted
      mean over bits                                          (:70-81)
  * optional masking of code logits by the detached hard mask (:47-48)
  * total = binary_loss_weight * code + mask (+ entire_mask)
      (train_v2.py:266)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from zebrapose_tpu_torch.parallel.mesh import World, all_reduce_


def sigmoid_l1_mask_loss(mask_logits: torch.Tensor,
                         gt_mask: torch.Tensor) -> torch.Tensor:
    """MaskLoss: mean |sigmoid(logit) - gt|."""
    if mask_logits.ndim == gt_mask.ndim + 1:
        mask_logits = mask_logits[..., 0]
    return torch.mean(torch.abs(torch.sigmoid(mask_logits) - gt_mask))


def hamming_histogram(code_logits: torch.Tensor, gt_code: torch.Tensor,
                      mask_hard: torch.Tensor, world: Optional[World] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean hamming loss, per-bit error histogram [n_bits]); mask_hard
    is the binarized {0,1} predicted mask (train_v2.py:258-260).

    With a `world` of more than one rank the histogram is the global
    batch's: the numerator and the denominator are all-reduced before
    the division (an average of the ranks' ratios would weight each
    rank's pixels by its own mask size), so the EMA and the bit weights
    agree on every rank."""
    if mask_hard.ndim == code_logits.ndim:
        mask_hard = mask_hard[..., 0]
    mask_hard = torch.clamp(torch.round(mask_hard), 0.0, 1.0)
    pred_hard = torch.clamp(torch.round(torch.sigmoid(code_logits)), 0.0, 1.0)
    gt_hard = torch.clamp(torch.round(gt_code), 0.0, 1.0)
    hamm = torch.abs(pred_hard - gt_hard) * mask_hard[..., None]
    errors, pixels = hamm.sum(dim=(0, 1, 2)), mask_hard.sum()
    if world is not None and world.distributed:
        both = torch.cat([errors, pixels[None]])
        all_reduce_([both], world)
        errors, pixels = both[:-1], both[-1]
    histogram = errors / (pixels + 1.0)
    return histogram.mean(), histogram


def _bce_with_logits(logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCEWithLogitsLoss (stable log-sum-exp form)."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def weighted_bce_per_bit(code_logits: torch.Tensor, gt_code: torch.Tensor,
                         bin_weights: torch.Tensor) -> torch.Tensor:
    """BinaryLossWeighted: per-bit mean BCE, weighted mean over bits."""
    per_bit = _bce_with_logits(code_logits, gt_code).mean(dim=(0, 1, 2))
    return (per_bit * bin_weights).sum() / bin_weights.sum()


def histogram_bin_weights(histogram: torch.Tensor) -> torch.Tensor:
    """Soft 'coarse bits first' curriculum weights."""
    return torch.exp(torch.minimum(histogram, 0.51 - histogram) * 3.0)


@dataclasses.dataclass(frozen=True)
class CodeLossConfig:
    loss_type: str = "BCE"               # L1 | BCE | CE
    mask_code_loss: bool = True          # mask logits by detached mask
    use_histogram_weighting: bool = True
    base: int = 2                        # divided_number_each_iteration
    n_bits: int = 16
    ema_old: float = 0.95
    ema_new: float = 0.05


def binary_code_loss(code_logits: torch.Tensor, mask_logits: torch.Tensor,
                     gt_code: torch.Tensor,
                     histogram: Optional[torch.Tensor],
                     cfg: CodeLossConfig, world: Optional[World] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                torch.Tensor]:
    """BinaryCodeLoss.forward: (loss, new_histogram, hamming).

    The hamming histogram and the optional code-logit masking use the
    hard {0,1} predicted mask, detached. `histogram` is the EMA state
    [n_bits]; `fresh_histogram(n)` (a negative sentinel) on step 0
    reproduces the reference's `self.histogram is None`. `world`: the
    histogram over its global batch (`hamming_histogram`).
    """
    mask_hard = (mask_logits > 0).to(code_logits.dtype).detach()
    if mask_hard.ndim == code_logits.ndim and mask_hard.shape[-1] == 1:
        mask_b = mask_hard
    else:
        mask_b = mask_hard[..., None]

    hamm_loss = torch.zeros((), device=code_logits.device)
    new_hist = histogram
    bin_weights = None
    if cfg.use_histogram_weighting:
        with torch.no_grad():
            hamm_loss, hist_new = hamming_histogram(code_logits, gt_code,
                                                    mask_hard, world)
            # EMA; a negative sentinel histogram means "uninitialized"
            new_hist = torch.where(
                torch.all(histogram < 0), hist_new,
                hist_new * cfg.ema_new + histogram * cfg.ema_old)
            bin_weights = histogram_bin_weights(new_hist)

    if cfg.mask_code_loss:
        code_logits = mask_b * code_logits

    if cfg.loss_type == "L1":
        loss = torch.mean(torch.abs(torch.sigmoid(code_logits) - gt_code))
    elif cfg.loss_type == "BCE" and not cfg.use_histogram_weighting:
        loss = torch.mean(_bce_with_logits(code_logits, gt_code))
    elif cfg.loss_type == "BCE":
        loss = weighted_bce_per_bit(code_logits, gt_code, bin_weights)
    elif cfg.loss_type == "CE":
        # channels = n_bits groups of `base` logits; gt digits in [0, base)
        grouped = code_logits.reshape(code_logits.shape[:-1]
                                      + (cfg.n_bits, cfg.base))
        logp = F.log_softmax(grouped, dim=-1)
        gt = gt_code.to(torch.int64)
        loss = -torch.take_along_dim(logp, gt[..., None], dim=-1).mean()
    else:
        raise NotImplementedError(cfg.loss_type)
    return loss, new_hist, hamm_loss


def total_loss(outputs: Dict[str, torch.Tensor],
               gt_mask: torch.Tensor,
               gt_entire_mask: Optional[torch.Tensor],
               gt_code: torch.Tensor,
               histogram: torch.Tensor,
               cfg: CodeLossConfig,
               binary_loss_weight: float = 3.0,
               world: Optional[World] = None
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Dict[str, torch.Tensor]]:
    """Train objective (train_v2.py:262-269): (loss, new_histogram,
    metrics). The losses are computed in float32 whatever the model's
    compute type; the histogram over `world`'s global batch."""
    outputs = {k: v.float() for k, v in outputs.items()}
    code_l, new_hist, hamm = binary_code_loss(
        outputs["code"], outputs["mask"], gt_code, histogram, cfg, world)
    mask_l = sigmoid_l1_mask_loss(outputs["mask"], gt_mask)
    metrics = {"loss_code": code_l, "loss_mask": mask_l, "hamming": hamm}
    loss = binary_loss_weight * code_l + mask_l
    if "entire_mask" in outputs and gt_entire_mask is not None:
        em_l = sigmoid_l1_mask_loss(outputs["entire_mask"], gt_entire_mask)
        metrics["loss_entire_mask"] = em_l
        loss = loss + em_l
    metrics["loss_total"] = loss
    return loss, new_hist, metrics


def fresh_histogram(n_bits: int, device=None) -> torch.Tensor:
    """Uninitialized-EMA sentinel (reference: self.histogram = None)."""
    return -torch.ones((n_bits,), dtype=torch.float32, device=device)
