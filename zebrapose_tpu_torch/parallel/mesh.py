"""The data-parallel world: one process per card, joined by
torch.distributed.

Port of `zebrapose_tpu/parallel/mesh.py`. JAX runs one controller over a
device mesh and lets GSPMD insert the collectives; the port runs one
process per card (started by `torchrun`, `python -m
torch.distributed.run`) and a `World` names this process's place in it:
its rank, the number of ranks, its local rank and its device. JAX's
`train` on N local chips is the port's `train` under `torchrun
--nproc_per_node N`; JAX's `--multihost` (`jax.distributed.initialize`)
is the same over several nodes.

The semantics are JAX's, not DDP's per-replica recipe: BatchNorm
statistics (`models/layers.py::TorchBatchNorm`), the bit-error histogram
(`models/losses.py::hamming_histogram`) and the logged metrics are taken
over the global batch, and the gradient is the gradient of the global
mean loss (`train/train_step.py`). Only `all_reduce` and `broadcast`
touch device tensors: gloo runs those two on CUDA tensors, so two ranks
can share one card over gloo; NCCL refuses two ranks on one device.
Objects (`all_gather_object`) travel on the CPU with gloo and on the
rank's card with NCCL. A train state's world reaches its model's
BatchNorm layers (`train/state.py::create_train_state`) and its losses
(`train_step.py`); evaluation and the fleet's members (each a world of
one) keep the one-process layers.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from zebrapose_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the data-parallel world: rank r of `size`
    runs on `device` (cuda:LOCAL_RANK under torchrun); `backend` is the
    process group's, None without one. With size 1 nothing is
    exchanged, whether a process group exists or not."""
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes checkpoints, logs and results."""
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        return self.size > 1


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default) or default)


def initialize_multihost(backend: Optional[str] = None, device=None,
                         init_method: Optional[str] = None,
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None,
                         timeout_s: float = 1800.0) -> World:
    """Join the process group and return this rank's World (replaces
    `jax.distributed.initialize`). Under torchrun the rendezvous, rank
    and size come from its environment; elsewhere pass `init_method`
    (`tcp://localhost:<port>` or `file://<path>`), `rank` and
    `world_size`. `backend` is NCCL for a CUDA device and gloo for the
    CPU unless given: `backend="gloo"` with a CUDA device runs the
    ranks' all-reduces and broadcasts through the host (two ranks on
    one card). Raises when there is no world to join."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0))
    if not dist.is_initialized():
        if init_method is None and "MASTER_ADDR" not in os.environ:
            raise RuntimeError(
                "no torch.distributed world to join: start the command "
                "under torchrun (python -m torch.distributed.run "
                "--nproc_per_node N ...) or pass init_method, rank and "
                "world_size")
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = {} if init_method is None else dict(
            init_method=init_method, rank=rank, world_size=world_size)
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    elif dev.type == "cuda":
        torch.cuda.set_device(dev)
    return World(rank=dist.get_rank(), size=dist.get_world_size(),
                 local_rank=_env_int("LOCAL_RANK", dist.get_rank()),
                 device=dev, backend=dist.get_backend())


def make_mesh(device=None) -> World:
    """The world this process trains in: the torchrun world when its
    environment has WORLD_SIZE > 1 (or a process group is already
    joined), else a world of one on `device` (resolved as the entry
    points resolve it: CUDA unless "cpu" is asked for)."""
    if dist.is_initialized() or _env_int("WORLD_SIZE", 1) > 1:
        return initialize_multihost(device=device)
    return World(device=resolve_device(device))


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Collectives (all_reduce and broadcast on device tensors only)
# ---------------------------------------------------------------------------

def _flat_groups(tensors: Sequence[torch.Tensor]):
    """The tensors grouped by (device, dtype), each group's order kept."""
    groups: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return groups.values()


def _on_wire(t: torch.Tensor, world: World) -> torch.Tensor:
    """NCCL moves tensors on the rank's card; gloo moves them where they
    are."""
    return t.to(world.device) if world.backend == "nccl" else t


def all_reduce_(tensors: Sequence[torch.Tensor], world: World,
                mean: bool = False) -> None:
    """Sum (or average) each tensor over the world in place, one flat
    all-reduce a device and dtype."""
    if not world.distributed:
        return
    for idx in _flat_groups(tensors):
        group = [tensors[i] for i in idx]
        flat = _on_wire(torch.cat([t.reshape(-1) for t in group]), world)
        dist.all_reduce(flat)
        if mean:
            flat /= world.size
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


def broadcast_(tensors: Sequence[torch.Tensor], world: World,
               src: int = 0) -> None:
    """Rank `src`'s values of each tensor on every rank, in place."""
    if not world.distributed:
        return
    for idx in _flat_groups(tensors):
        group = [tensors[i] for i in idx]
        flat = _on_wire(torch.cat([t.reshape(-1) for t in group]), world)
        dist.broadcast(flat, src)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the world with autograd: the gradient of every rank's
    sum flows back to every rank's input (the backward all-reduces the
    output's gradient)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the default process group, differentiable (the
    global-batch statistics of `models/layers.py::TorchBatchNorm`)."""
    return _AllReduceSum.apply(x)


def mean_over_world(metrics: Dict[str, torch.Tensor], world: World
                    ) -> Dict[str, torch.Tensor]:
    """Each 0-d metric averaged over the world (one all-reduce)."""
    if not world.distributed or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    all_reduce_([flat], world, mean=True)
    return dict(zip(keys, flat.unbind()))


def broadcast_object(obj: Any, world: World, src: int = 0) -> Any:
    """Rank `src`'s picklable `obj` on every rank."""
    if not world.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, device=_object_device(world))
    return box[0]


def all_gather_object(obj: Any, world: World) -> List[Any]:
    """Every rank's picklable `obj`, in rank order, on every rank."""
    if not world.distributed:
        return [obj]
    out: List[Any] = [None] * world.size
    if world.backend == "nccl":
        torch.cuda.set_device(world.device)
    dist.all_gather_object(out, obj)
    return out


def _object_device(world: World):
    return world.device if world.backend == "nccl" else torch.device("cpu")


def replicate(world: World, state) -> None:
    """Rank 0's train state on every rank, in place: parameters and
    buffers, Adam's moments and step counts, the histogram, the step and
    the best score. Every rank restores the same checkpoint, so this
    makes a fresh start agree; a resume at different steps is
    refused."""
    if not world.distributed:
        return
    # (max step, -min step) over the ranks
    steps = torch.tensor([float(state.step), -float(state.step)],
                         dtype=torch.float64)
    _all_reduce_max(steps, world)
    if steps[0] != -steps[1]:
        raise ValueError(
            f"ranks restored different steps ({int(-steps[1])}.."
            f"{int(steps[0])}); every rank must resume the same "
            "checkpoint")
    tensors = list(state.model.state_dict().values())
    for p in state.model.parameters():
        st = state.optimizer.state.get(p, {})
        tensors += [st[k] for k in ("step", "exp_avg", "exp_avg_sq")
                    if k in st]
    tensors.append(state.histogram)
    broadcast_(tensors, world)
    state.best_score = broadcast_object(float(state.best_score), world)


def _all_reduce_max(t: torch.Tensor, world: World) -> None:
    wire = _on_wire(t, world)
    dist.all_reduce(wire, op=dist.ReduceOp.MAX)
    t.copy_(wire)


def shard_batch(world: World, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch: [r·n/W, (r+1)·n/W) of each
    leaf (n must split evenly)."""
    if not world.distributed:
        return batch
    n = len(next(iter(batch.values())))
    local = local_batch_size(n, world.size)
    lo = world.rank * local
    return {k: v[lo:lo + local] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# World-size arithmetic (the JAX package's, with n_processes = world)
# ---------------------------------------------------------------------------

def scale_for_world(learning_rate: float, total_iteration: int,
                    world_size: int) -> tuple:
    """The reference's DDP scaling recipe (train_v5.py:82-91): lr *=
    world_size, iterations //= world_size."""
    return learning_rate * world_size, total_iteration // world_size


def local_batch_size(global_batch: int, n_processes: int = 1) -> int:
    """Per-process slice of the global batch; exact division only (a
    silent floor would train on a smaller global batch than
    configured)."""
    if n_processes <= 1:
        return global_batch
    if global_batch % n_processes:
        raise ValueError(
            f"batch_size {global_batch} not divisible by process count "
            f"{n_processes}; the global batch must split evenly across "
            "hosts")
    return global_batch // n_processes


def validate_batch_partition(global_batch: int, accum_steps: int,
                             world: int, n_processes: int = 1) -> int:
    """Check that `global_batch` splits into micro-batches of equal size
    on every device and return the per-process micro-batch size
    (cfg.batch_size is the effective batch of one optimizer step). The
    port runs one process a card: world = n_processes."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    local = local_batch_size(global_batch, n_processes)
    if local % accum_steps:
        raise ValueError(
            f"local batch {local} not divisible by accum_steps "
            f"{accum_steps}; cfg.batch_size is the EFFECTIVE batch and "
            f"must split evenly into micro-batches")
    local //= accum_steps
    local_devices = max(world // max(n_processes, 1), 1)
    if local % local_devices:
        raise ValueError(
            f"micro-batch {local} per process (batch_size {global_batch} "
            f"/ accum_steps {accum_steps} / {n_processes} processes) not "
            f"divisible by the {local_devices} local mesh devices; "
            "batch_size must be a multiple of accum_steps * total device "
            "count")
    return local
