"""World-size arithmetic of data-parallel training, for one process.

The port's copies of `scale_for_world`, `local_batch_size` and
`validate_batch_partition` from `zebrapose_tpu/parallel/mesh.py`
(:63-109, :130-134). The port trains on one device in one process;
torch DDP across cards is not ported yet (ROADMAP.md, A item 7).
"""

from __future__ import annotations


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
            f"{n_processes}; the global batch must split evenly")
    return global_batch // n_processes


def validate_batch_partition(global_batch: int, accum_steps: int,
                             world: int, n_processes: int = 1) -> int:
    """Check that `global_batch` splits into micro-batches of equal size
    on every device and return the per-process micro-batch size
    (cfg.batch_size is the effective batch of one optimizer step)."""
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
            f"divisible by the {local_devices} local devices; batch_size "
            f"must be a multiple of accum_steps * total device count")
    return local
