"""Training orchestration: the reference's train_v2 loop, on one card or
on a data-parallel world of them.

Port of `zebrapose_tpu/train/trainer.py` (train_v2.py:226-344): every
`log_freq` steps it logs the losses and the bit-error histogram, saves a
rolling checkpoint and validates, either by pose (decode -> EPnP-RANSAC
-> ADD recall through the port's inference path, which launches the
EPnP CUDA kernel, keeping the best checkpoint by recall) or by loss
alone (train_v6). `build_train_setup` assembles everything from a BOP
tree; `fit` is orchestration over injected resources, so tests drive it
on synthetic data.

Input modes (`build_train_setup`): stream (`MixedBatchIterator`, host
arrays copied at each step), prefetch (the same wrapped in
`DevicePrefetchIterator`: copies one step ahead on a side stream) and
device_cache (`DeviceDatasetCache`: the splits' pixels on the device,
batches gathered there). `train_step_cost` counts one train step's
FLOPs. The fleet trainer (K objects in one program) is `train/fleet.py`.

Data parallelism (`parallel/mesh.py`, one process a card under
torchrun): `build_train_setup(world=)` scales lr × W and iterations ÷ W
(`scale_for_world`), draws each rank's share of the global batch from
iterators seeded with the rank (JAX's `seed=jax.process_index()`), seeds
the augmentation from (draw, rank), and starts every rank from rank 0's
state (`replicate`). In `fit` only rank 0 writes checkpoints and logs,
and pose validation runs once, on rank 0, whose recall is broadcast, so
the best score and the best checkpoint agree on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.data.pipeline import (
    FEED_KEYS,
    CachedBatchIterator,
    CropDatasetHost,
    DeviceDatasetCache,
    DevicePrefetchIterator,
    MixedBatchIterator,
    gather_preprocess_batch,
    preprocess_batch,
)
from zebrapose_tpu_torch.eval.evaluate import evaluate_object, make_eval_step
from zebrapose_tpu_torch.models.losses import CodeLossConfig
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.ops.pnp import PnPConfig
from zebrapose_tpu_torch.parallel.mesh import (
    World,
    broadcast_object,
    make_mesh,
    replicate,
    scale_for_world,
    shard_batch,
    validate_batch_partition,
)
from zebrapose_tpu_torch.train.checkpoints import CheckpointManager
from zebrapose_tpu_torch.train.state import TrainState, create_train_state
from zebrapose_tpu_torch.train.train_step import (
    accum_train_step,
    eval_loss_step,
    forward_eval,
    grad_step,
    train_step,
)
from zebrapose_tpu_torch.utils.logging import MetricsLogger, NullLogger
from zebrapose_tpu_torch.utils.profiling import count_flops, span

@dataclasses.dataclass
class TrainResources:
    cfg: ZebraConfig
    model: ZebraPoseNet
    state: TrainState
    train_iter: Iterator[Dict[str, np.ndarray]]
    val_dataset: Optional[CropDatasetHost]
    lut: CorrespondenceLUT
    vertices: np.ndarray
    diameter: float
    symmetric: bool
    obj_id: int
    obj_name: str
    ckpt: CheckpointManager
    logger: MetricsLogger
    total_iterations: int
    device: torch.device
    pnp_cfg: PnPConfig = PnPConfig()
    val_batch_size: int = 16
    # k micro-batches of cfg.batch_size / k per optimizer step (1 = off);
    # the train iterator yields micro-batches
    accum_steps: int = 1
    bf16: bool = False
    # device_cache mode: the splits' pixels on the device; train_iter
    # then yields indices (CachedBatchIterator)
    device_cache: Optional[DeviceDatasetCache] = None
    # the data-parallel world (one rank: one process); train_iter yields
    # this rank's share of each global (micro-)batch
    world: World = World()


def _loss_cfg(cfg: ZebraConfig) -> CodeLossConfig:
    return CodeLossConfig(
        loss_type=cfg.BinaryCode_Loss_Type,
        mask_code_loss=cfg.mask_binary_code_loss,
        use_histogram_weighting=cfg.use_histgramm_weighted_binary_loss,
        base=cfg.divide_number_each_itration,
        n_bits=cfg.number_of_itration)


def _to_device(raw: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(raw[k]).to(dev) for k in FEED_KEYS}


def aug_generator(index: int, device, rank: int = 0) -> torch.Generator:
    """The augmentation generator of draw `index` (a step, or a
    micro-batch under accumulation) on rank `rank`, seeded from both:
    the counterpart of JAX's fold_in(key, index), so a resumed run draws
    what an uninterrupted one would, and ranks draw different noise for
    their rows. Rank 0's seed is the index."""
    return torch.Generator(device=device).manual_seed(
        int(index) + (int(rank) << 40))


def _make_batch_fn(res: TrainResources,
                   clock: Optional[Dict[str, float]] = None):
    """The per-draw batch closure shared by fit(), timed_steps() and
    train_step_cost(): one (micro-)batch from res.train_iter,
    preprocessed and augmented on the device with
    `aug_generator(aug_index)` in every input mode: gathered from
    res.device_cache by index, taken as the device tensors a
    `DevicePrefetchIterator` hands out, or copied from host arrays.
    `clock["wait_s"]` adds the time spent waiting for it."""
    cfg = res.cfg
    kw = dict(crop_img=cfg.BoundingBox_CropSize_image,
              crop_gt=cfg.BoundingBox_CropSize_GT,
              base=cfg.divide_number_each_itration,
              n_bits=cfg.number_of_itration,
              resize_method=cfg.resize_method,
              use_pepper_salt=cfg.use_peper_salt,
              use_motion_blur=cfg.use_motion_blur)

    def _next_batch(aug_index: int) -> Dict[str, torch.Tensor]:
        with span("zebrapose.run.wait_s", clock):
            raw = next(res.train_iter)
        gen = aug_generator(aug_index, res.device, res.world.rank)
        if res.device_cache is not None:
            return gather_preprocess_batch(
                res.device_cache.arrays, raw["idx"], raw["roi_param"],
                raw["valid"], gen, **kw)
        feed = raw if getattr(res.train_iter, "device_resident", False) \
            else _to_device(raw, res.device)
        return preprocess_batch(feed, is_train=True, generator=gen, **kw)

    return _next_batch


def _one_step(res: TrainResources, next_batch, it: int,
              loss_cfg: CodeLossConfig) -> Dict[str, torch.Tensor]:
    cfg = res.cfg
    kw = dict(binary_loss_weight=float(cfg.binary_loss_weight),
              predict_entire_mask=cfg.predict_entire_mask, bf16=res.bf16)
    accum = max(int(res.accum_steps), 1)
    if accum == 1:
        return train_step(res.state, next_batch(it), loss_cfg, **kw)
    return accum_train_step(
        res.state, (next_batch(it * accum + j) for j in range(accum)),
        loss_cfg, **kw)


def _validate_loss_only(res: TrainResources, state: TrainState,
                        loss_cfg: CodeLossConfig) -> Dict[str, float]:
    """Loss-only validation (train_v6.py:364-399): the mean losses over
    the val split, no pose decode; logged, never selecting a best
    checkpoint. The ragged tail is padded by wrapping around. In a world
    of W ranks each batch is padded to a multiple of W, every rank takes
    its rows, and the losses are the global batch's (`eval_loss_step`
    averages them over the ranks), as JAX's batch sharded over its
    mesh."""
    cfg = res.cfg
    ds = res.val_dataset
    n = len(ds)
    if n == 0:
        return {}
    w = res.world.size
    bs = max(w, -(-max(res.val_batch_size, 1) // w) * w)
    sums: Dict[str, float] = {}
    n_batches = 0
    for start in range(0, n, bs):
        raw = shard_batch(res.world, ds.collate(
            [(start + j) % n for j in range(bs)]))
        batch = preprocess_batch(
            _to_device(raw, res.device),
            crop_img=cfg.BoundingBox_CropSize_image,
            crop_gt=cfg.BoundingBox_CropSize_GT,
            base=cfg.divide_number_each_itration,
            n_bits=cfg.number_of_itration, resize_method=cfg.resize_method)
        metrics = eval_loss_step(
            state, batch, loss_cfg,
            binary_loss_weight=float(cfg.binary_loss_weight),
            predict_entire_mask=cfg.predict_entire_mask, bf16=res.bf16)
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n_batches += 1
    return {k: v / n_batches for k, v in sums.items()}


def timed_steps(res: TrainResources, n_steps: int = 500, warm: int = 20,
                timing: Optional[Dict[str, float]] = None) -> float:
    """Sustained optimizer rate: `warm` unmeasured steps, then `n_steps`
    timed steps; returns ms a step on the host clock, from a drained
    device to the last step's loss read back. `timing`, when given,
    gets host_ms and wait_s (waiting for batches in the timed steps).
    Neither saves checkpoints nor closes res.train_iter; res.state
    advances."""
    loss_cfg = _loss_cfg(res.cfg)
    clock = {"wait_s": 0.0, "host_s": 0.0}
    next_batch = _make_batch_fn(res, clock)
    dev = res.device
    for it in range(warm):
        _one_step(res, next_batch, it, loss_cfg)
    clock["wait_s"] = 0.0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with span("zebrapose.run.host_s", clock):
        for it in range(warm, warm + n_steps):
            metrics = _one_step(res, next_batch, it, loss_cfg)
        float(metrics["loss_total"])
    ms = clock["host_s"] / n_steps * 1e3
    if timing is not None:
        timing.update(host_ms=ms, wait_s=clock["wait_s"])
    return ms


def train_step_cost(res: TrainResources) -> Dict[str, float]:
    """FLOPs of one train step, forward and backward, at res's shapes:
    one batch drawn as fit() draws them (one draw from res.train_iter,
    augmentation index 0, as in JAX), then the step's forward, losses
    and backward under `torch.utils.flop_counter.FlopCounterMode`
    (`utils/profiling.py::count_flops`: matmuls and convolutions; Adam's
    elementwise update counts 0). Runs on a copy of the model, so
    res.state (parameters, BN statistics, the Adam state, the histogram,
    the step) is left as it was.

    Returns {"flops": ...}. The JAX package returns XLA's cost analysis
    of the compiled step, which also has "bytes accessed"; eager
    PyTorch has no counterpart, so that key is left out."""
    cfg = res.cfg
    batch = _make_batch_fn(res)(0)
    model = copy.deepcopy(res.state.model)
    probe = TrainState(model=model, optimizer=None,
                       schedule=res.state.schedule,
                       histogram=res.state.histogram.clone())
    flops = count_flops(
        grad_step, probe, batch, _loss_cfg(cfg),
        float(cfg.binary_loss_weight), cfg.predict_entire_mask, res.bf16)
    return {"flops": float(flops)}


def fit(res: TrainResources, log_freq: int = 1000, validate: bool = True,
        max_steps: Optional[int] = None, val_mode: str = "pose",
        timing: Optional[Dict[str, float]] = None) -> float:
    """Run the training loop from res.state.step; returns the best
    validation recall.

    val_mode: "pose" = decode -> PnP -> ADD recall validation with
    best-checkpoint selection (train_v2); "loss" = loss-only validation,
    logged, never selecting a best checkpoint (train_v6). At every log
    step: the metrics of that step and the histogram (`train/`), each
    step's loss_total since the last log (`train/step_loss_total`), a
    rolling checkpoint, then validation (`val/`) with the model in eval
    mode, so it moves no BN statistics.

    `timing`, when given, is filled with seconds of this call: fit_s,
    wait_s (waiting for the next batch), step_s (issuing the steps; the
    device works behind them), log_s (logging and checkpoint copies,
    which wait for the device) and val_s.

    In a world of several ranks every rank calls fit: the steps run on
    all of them, rank 0 alone logs, checkpoints and validates by pose
    (the others wait for its recall), and the loss-only validation runs
    on all of them over their rows.
    """
    if val_mode not in ("pose", "loss"):
        raise ValueError(f"unknown val_mode: {val_mode}")
    t_run = time.perf_counter()
    cfg = res.cfg
    loss_cfg = _loss_cfg(cfg)
    state = res.state
    dev = res.device
    world = res.world
    clock = dict.fromkeys(("wait_s", "step_s", "log_s", "val_s"), 0.0)

    pose_val = validate and val_mode == "pose" and \
        res.val_dataset is not None
    eval_step = None
    if pose_val and world.is_main:
        # built once; its forward runs the live model with the running
        # BN statistics. Inference reads only batch["image"].
        eval_step = make_eval_step(
            lambda b: forward_eval(state, b["image"], res.bf16), res.lut,
            crop_img=cfg.BoundingBox_CropSize_image,
            crop_gt=cfg.BoundingBox_CropSize_GT,
            base=cfg.divide_number_each_itration,
            n_bits=cfg.number_of_itration, resize_method=cfg.resize_method,
            loss_type=cfg.BinaryCode_Loss_Type, pnp_cfg=res.pnp_cfg,
            preprocess_gt=False, device=dev)

    best = float(state.best_score)
    start_step = int(state.step)
    end_step = res.total_iterations if max_steps is None else \
        min(start_step + max_steps, res.total_iterations)
    next_batch = _make_batch_fn(res, clock)
    step_losses = []

    try:
        for it in range(start_step, end_step):
            waited = clock["wait_s"]
            with span("zebrapose.run.step_s", clock):
                metrics = _one_step(res, next_batch, it, loss_cfg)
            clock["step_s"] -= clock["wait_s"] - waited
            step_losses.append(metrics["loss_total"])

            if (it + 1) % log_freq == 0 or it + 1 == end_step:
                with span("zebrapose.run.log_s", clock):
                    scalars = {k: float(v) for k, v in metrics.items()}
                    hist = state.histogram.cpu().numpy()
                    scalars.update({f"bit_err_{i}": float(h)
                                    for i, h in enumerate(hist)})
                    res.logger.log(it + 1, scalars, prefix="train/")
                    res.logger.log_series(
                        "train/step_loss_total",
                        range(it + 2 - len(step_losses), it + 2),
                        torch.stack(step_losses).cpu().tolist())
                    step_losses = []
                    res.ckpt.save(state)

                with span("zebrapose.run.val_s", clock):
                    if pose_val:
                        recall = None
                        if eval_step is not None:
                            r = evaluate_object(
                                res.val_dataset, eval_step, res.vertices,
                                res.diameter, res.symmetric, res.obj_id, "val",
                                res.obj_name, batch_size=res.val_batch_size,
                                device=dev)
                            prefix = "ADD-S" if res.symmetric else "ADD"
                            recall = r.metrics[f"{prefix}_recall_0.1d"]
                            res.logger.log(it + 1, r.metrics, prefix="val/")
                        recall = broadcast_object(recall, world)
                        if recall > best:
                            best = recall
                            state.best_score = best
                            res.ckpt.save_best(state, best)
                    elif (validate and val_mode == "loss"
                            and res.val_dataset is not None):
                        res.logger.log(it + 1, _validate_loss_only(
                            res, state, loss_cfg), prefix="val/")
    finally:
        res.train_iter.close()
        res.ckpt.wait()   # the writes in flight reach the disk
    if timing is not None:
        timing.update(clock, fit_s=time.perf_counter() - t_run,
                      steps=end_step - start_step)
    return best


_PRETRAINED_CANDIDATES = (
    "pretrained_backbone/resnet/resnet34-333f7ec4.pth",
    "pretrained_backbone/resnet34-333f7ec4.pth",
)


def _resolve_pretrained(pretrained_backbone: Optional[str]
                        ) -> Optional[str]:
    """The ImageNet backbone .pth. The reference always trains from
    torchvision resnet34 ImageNet weights (model/resnet.py:186-189), so
    "auto" fails loudly when none is found; None trains from scratch
    (--from_scratch)."""
    if pretrained_backbone is None:
        return None
    if pretrained_backbone != "auto":
        if not os.path.exists(pretrained_backbone):
            raise FileNotFoundError(
                f"pretrained backbone not found: {pretrained_backbone}")
        return pretrained_backbone
    env = os.environ.get("ZEBRAPOSE_PRETRAINED_BACKBONE")
    candidates = ([env] if env else []) + [
        os.path.join(base, rel)
        for base in (os.getcwd(),
                     os.path.dirname(os.path.dirname(
                         os.path.dirname(os.path.abspath(__file__)))))
        for rel in _PRETRAINED_CANDIDATES]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise FileNotFoundError(
        "No ImageNet backbone weights found (searched "
        f"{candidates}). The reference always initializes from "
        "torchvision resnet34-333f7ec4.pth (model/resnet.py:186-189); "
        "point ZEBRAPOSE_PRETRAINED_BACKBONE or --pretrained_backbone at "
        "it, or pass --from_scratch to train from random init.")


def _warn_ignored_config(cfg: ZebraConfig) -> None:
    """Fail or warn on accepted-but-unsupported knobs instead of
    silently ignoring them."""
    import warnings

    if str(cfg.optimizer_type) != "Adam":
        raise ValueError(
            f"optimizer_type={cfg.optimizer_type!r} is not supported: "
            "every reference recipe uses Adam (train_v2.py:206)")
    if cfg.tensorboard_path not in ("tb/", "", "none", None):
        warnings.warn(
            "tensorboard_path is ignored: metrics go to JSONL under "
            "<output_dir>/logs (plus tensorboardX if installed)",
            stacklevel=3)


def build_train_setup(cfg: ZebraConfig, obj_name: str, output_dir: str,
                      gt_dir_suffix: str = "_GT_v2", variant: str = "v2",
                      pretrained_backbone: Optional[str] = "auto",
                      max_val_samples: int = 512, bf16: bool = False,
                      gamma: float = 1.0, log_freq: int = 1000,
                      cache_images: bool = False, accum_steps: int = 1,
                      qat: bool = False, device_cache: bool = False,
                      device_prefetch: bool = False,
                      device=None, world: Optional[World] = None,
                      write: Optional[bool] = None) -> TrainResources:
    """Assemble TrainResources from a BOP tree (train_v2.py:40-223) on
    `device` (CUDA unless "cpu" is asked for), for this rank of `world`
    (default `parallel.mesh.make_mesh(device)`: the torchrun world when
    there is one, else one process on `device`).

    pretrained_backbone: a torchvision resnet34 .pth, "auto" (search the
    known places and fail when absent) or None (from scratch; the model
    is initialized under torch.manual_seed(0) without touching the
    caller's RNG). gamma: StepLR decay per 10 log cadences (1.0 =
    train_v2/v5, 0.7 = train_v3); log_freq must be fit()'s. accum_steps:
    cfg.batch_size stays the effective batch; the iterator yields
    batch_size / accum_steps micro-batches. cache_images holds decoded
    frames in host RAM (~2.4 MB a 480x640 sample). With
    cfg.load_checkpoint the latest rolling checkpoint under
    `<output_dir>/checkpoints` is restored. qat: quantization-aware
    training, the convs above the int8 gate run the differentiable int8
    simulation (`models/layers.py::_fake_quant_conv`), so `fit`'s pose
    validation measures the quantized forward too; the parameters are
    unchanged, so the checkpoints load into an int8 model (`test
    --int8`). Start from a float checkpoint (cfg.load_checkpoint) and
    fine-tune briefly, as with the JAX package. device_cache: the
    training splits' pixels go to the device once (`DeviceDatasetCache`,
    ~2.46 MB a 480x640 sample) and each step gathers its batch there;
    device_prefetch: the streamed batches are copied one step ahead on a
    side stream (`DevicePrefetchIterator`). The batches' draws are the
    same in every mode. In a world of W ranks: lr × W and iterations ÷ W
    (the reference's DDP recipe, train_v5.py:82-91), each rank's
    iterator yields batch_size / W / accum_steps rows from its own
    stream (seed = rank), the device cache holds the whole split on
    each rank's card, only rank 0 writes checkpoints and logs (`write`,
    default: whether this is rank 0), and every rank starts from rank
    0's state.
    """
    from zebrapose_tpu_torch.codec.lut import load_correspondence_lut
    from zebrapose_tpu_torch.data import bop_io
    from zebrapose_tpu_torch.data.dataset_info import (
        is_symmetric,
        lookup_obj_id,
    )
    from zebrapose_tpu_torch.models.convert import load_torchvision_resnet34

    if world is None:
        world = make_mesh(device)
    if write is None:
        write = world.is_main
    dev = world.device
    _warn_ignored_config(cfg)
    pretrained_backbone = _resolve_pretrained(pretrained_backbone)
    # fail fast on an unsplittable batch before any dataset/model work
    local_batch = validate_batch_partition(cfg.batch_size, accum_steps,
                                           world.size, world.size)
    obj_id = lookup_obj_id(cfg.dataset_name, obj_name)

    def train_split(folder):
        samples = bop_io.get_dataset(
            cfg.bop_path, cfg.dataset_name, train=True, data_folder=folder,
            train_obj_visible_theshold=cfg.train_obj_visible_theshold)
        return samples, CropDatasetHost(
            samples.dataset_dir, folder, *samples.for_obj(obj_id),
            is_train=True, crop_size_img=cfg.BoundingBox_CropSize_image,
            crop_size_gt=cfg.BoundingBox_CropSize_GT,
            padding_ratio=cfg.padding_ratio,
            resize_method=cfg.resize_method, gt_dir_suffix=gt_dir_suffix,
            cache_images=cache_images)

    train1, ds1 = train_split(cfg.training_data_folder)
    ds2 = None
    if cfg.training_data_folder_2 not in ("none", "", None):
        _, ds2 = train_split(cfg.training_data_folder_2)

    val = bop_io.get_dataset(cfg.bop_path, cfg.dataset_name, train=False,
                             data_folder=cfg.val_folder)
    val_lists = val.for_obj(obj_id)
    if len(val_lists[0]) > max_val_samples:
        sel = np.linspace(0, len(val_lists[0]) - 1,
                          max_val_samples).astype(int)
        val_lists = tuple([lst[i] for i in sel] for lst in val_lists)
    val_ds = CropDatasetHost(
        val.dataset_dir, cfg.val_folder, *val_lists, is_train=False,
        crop_size_img=cfg.BoundingBox_CropSize_image,
        crop_size_gt=cfg.BoundingBox_CropSize_GT,
        padding_ratio=cfg.padding_ratio, resize_method=cfg.resize_method,
        gt_dir_suffix=gt_dir_suffix)

    lut = load_correspondence_lut(os.path.join(
        cfg.bop_path, cfg.dataset_name, "models_GT_color",
        f"Class_CorresPoint{obj_id:06d}.txt"))
    mesh_data = bop_io.load_ply(train1.model_plys[obj_id])
    diameter = float(train1.model_info[str(obj_id)]["diameter"])

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ZebraPoseNet(
            binary_code_length=cfg.number_of_itration,
            base=cfg.divide_number_each_itration, variant=variant,
            resnet_layers=cfg.resnet_layer,
            concat=cfg.concat_encoder_decoder,
            output_kernel_size=cfg.output_kernel_size,
            quant="qat" if qat else False)
    if pretrained_backbone:
        load_torchvision_resnet34(model, torch.load(
            pretrained_backbone, map_location="cpu", weights_only=True))
    model = model.to(dev).to(memory_format=torch.channels_last).train()

    lr, iters = scale_for_world(cfg.learning_rate, cfg.total_iteration,
                                world.size)
    state = create_train_state(model, lr, n_bits=cfg.number_of_itration,
                               gamma=gamma, log_freq=log_freq, world=world)
    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"),
                             write=write)
    if cfg.load_checkpoint:
        state = ckpt.restore(state)
    replicate(world, state)
    logger = MetricsLogger(os.path.join(output_dir, "logs")) if write \
        else NullLogger()
    cache = None
    if device_cache:
        cache = DeviceDatasetCache([ds1, ds2], dev)
        train_iter = CachedBatchIterator(
            cache, batch_size=local_batch,
            second_dataset_ratio=cfg.second_dataset_ratio, seed=world.rank)
    else:
        train_iter = MixedBatchIterator(
            ds1, ds2, batch_size=local_batch,
            second_dataset_ratio=cfg.second_dataset_ratio, seed=world.rank,
            num_workers=cfg.num_workers)
        if device_prefetch:
            train_iter = DevicePrefetchIterator(train_iter, dev)

    return TrainResources(
        cfg=cfg, model=model, state=state, train_iter=train_iter,
        val_dataset=val_ds, lut=lut,
        vertices=mesh_data["pts"].astype(np.float32), diameter=diameter,
        symmetric=is_symmetric(cfg.dataset_name, obj_name), obj_id=obj_id,
        obj_name=obj_name, ckpt=ckpt, logger=logger,
        total_iterations=iters, device=dev, accum_steps=accum_steps,
        bf16=bf16, device_cache=cache, world=world)
