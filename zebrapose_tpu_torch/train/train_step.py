"""The training step: forward in train mode, loss stack, backward, Adam.

Port of `zebrapose_tpu/train/train_step.py` (the reference's
train_v2.py:252-269). PyTorch runs it eagerly on the state in place
(cuDNN convolutions, autograd, `torch.optim.Adam`); the returned
metrics are 0-d tensors on the device, so nothing waits for the card
until a caller reads one.

`bf16=True` runs the forward under `torch.autocast(bfloat16)` with the
parameters, gradients, optimizer and losses in float32: the counterpart
of the JAX model's `dtype=bfloat16`, not bit-comparable with it.

Gradient accumulation (`accum_train_step`): the parameters stay frozen
across the k micro-batches, the gradients add up in `.grad`, BatchNorm
running statistics and the histogram EMA advance micro-batch by
micro-batch, and the mean gradient is applied once. `train_step` is the
k = 1 case of the same functions.

Data parallelism (`state.world` with more than one rank, one process a
card): BatchNorm statistics (the model's layers hold the world,
`create_train_state`) and the histogram are the global batch's; the summed
gradients are all-reduced once, at the update (one flat all-reduce a
dtype, then divided by k·W: the gradient of the global mean loss, as
JAX sums micro-gradients and applies once), so every rank applies the
same gradient to the same weights and the replicas stay bit-identical;
the metrics are averaged over the world. Not DDP: its buckets
all-reduce during each micro-batch's backward, and the state dict's
names would change; the all-reduce at the update needs neither hooks
nor `no_sync`.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from zebrapose_tpu_torch.models.losses import CodeLossConfig, total_loss
from zebrapose_tpu_torch.parallel.mesh import all_reduce_, mean_over_world
from zebrapose_tpu_torch.train.state import TrainState
from zebrapose_tpu_torch.utils.profiling import span


def _forward(model, images, bf16: bool):
    with torch.autocast(images.device.type, dtype=torch.bfloat16,
                        enabled=bf16):
        return model(images)


def grad_step(state: TrainState, batch: Dict[str, torch.Tensor],
              loss_cfg: CodeLossConfig, binary_loss_weight: float = 3.0,
              predict_entire_mask: bool = True, bf16: bool = False
              ) -> Dict[str, torch.Tensor]:
    """Forward and backward of one micro-batch in train mode: the
    gradients are added to the parameters' `.grad` (no update), the BN
    running statistics and `state.histogram` advance. batch: {"image"
    [N,H,W,3] normalized, "mask" [N,h,w], "entire_mask" [N,h,w], "code"
    [N,h,w,bits]}."""
    state.model.train()
    with span("zebrapose.train.forward"):
        outputs = _forward(state.model, batch["image"], bf16)
    gt_entire = batch.get("entire_mask") if predict_entire_mask else None
    with span("zebrapose.train.loss"):
        loss, new_hist, metrics = total_loss(
            outputs, batch["mask"], gt_entire, batch["code"],
            state.histogram, loss_cfg, binary_loss_weight, state.world)
    with span("zebrapose.train.backward"):
        loss.backward()
    state.histogram = new_hist
    return {k: v.detach() for k, v in metrics.items()}


def apply_accumulated(state: TrainState, accum_steps: int) -> torch.Tensor:
    """One Adam update from the summed micro-gradients in `.grad` (mean =
    sum / k, over the world's ranks sum / (k·W)) at the schedule's lr for
    this step; returns the float32 norm of the applied gradient."""
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    n = accum_steps
    if state.world is not None and state.world.distributed:
        all_reduce_(grads, state.world)
        n *= state.world.size
    if n != 1:
        torch._foreach_div_(grads, float(n))
    grad_norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads)).float())
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    return grad_norm


def accum_train_step(state: TrainState,
                     micro_batches: Iterable[Dict[str, torch.Tensor]],
                     loss_cfg: CodeLossConfig,
                     binary_loss_weight: float = 3.0,
                     predict_entire_mask: bool = True, bf16: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """One optimizer step over k micro-batches; metrics are their mean,
    `grad_norm` is the norm of the applied mean gradient."""
    with span("zebrapose.train.step"):
        state.optimizer.zero_grad(set_to_none=True)
        msum, n = None, 0
        for batch in micro_batches:
            m = grad_step(state, batch, loss_cfg, binary_loss_weight,
                          predict_entire_mask, bf16)
            msum = m if msum is None else {k: msum[k] + m[k] for k in m}
            n += 1
        if n == 0:
            raise ValueError(
                "accum_train_step needs at least one micro-batch")
        metrics = {k: v / n for k, v in msum.items()}
        if state.world is not None:
            metrics = mean_over_world(metrics, state.world)
        with span("zebrapose.train.optimizer"):
            metrics["grad_norm"] = apply_accumulated(state, n)
        return metrics


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               loss_cfg: CodeLossConfig, binary_loss_weight: float = 3.0,
               predict_entire_mask: bool = True, bf16: bool = False
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on one batch: the metrics of total_loss plus
    `grad_norm`."""
    return accum_train_step(state, [batch], loss_cfg, binary_loss_weight,
                            predict_entire_mask, bf16)


def eval_loss_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   loss_cfg: CodeLossConfig, binary_loss_weight: float = 3.0,
                   predict_entire_mask: bool = True, bf16: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """Loss-only validation forward with the running BN statistics (the
    reference's train_v6.py:355-400); the histogram is read, not
    advanced. In a world of several ranks `batch` is this rank's rows
    and the metrics are the global batch's (the hamming histogram's
    sums all-reduced, the losses averaged over the ranks)."""
    outputs = forward_eval(state, batch["image"], bf16)
    gt_entire = batch.get("entire_mask") if predict_entire_mask else None
    with torch.no_grad():
        _, _, metrics = total_loss(
            outputs, batch["mask"], gt_entire, batch["code"],
            state.histogram, loss_cfg, binary_loss_weight, state.world)
    if state.world is not None:
        metrics = mean_over_world(metrics, state.world)
    return metrics


def forward_eval(state: TrainState, images: torch.Tensor,
                 bf16: bool = False) -> Dict[str, torch.Tensor]:
    """Inference forward with the running BN statistics; the model's
    train/eval mode is restored afterwards."""
    model = state.model
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return _forward(model, images, bf16)
    finally:
        model.train(was_training)
