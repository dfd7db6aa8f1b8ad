"""Training from scratch at the reference's batch: the port's
`train/train_step.py::train_step` (bf16 autocast forward, the loss
stack, backward, Adam, the BN statistics and the bit-error histogram)
on a `TrainState` made by `create_train_state` as `build_train_setup`
makes it, fed by the `--input_mode device_cache` path: the split's
uint8 frames, labels and masks in a `DeviceDatasetCache`, indices and
jittered crop params from `CachedBatchIterator`, the batch gathered,
cropped and augmented on the card by `gather_preprocess_batch`.

Traffic (`traffic/<name>.json`): `frames` frames of the split, rendered
on the device from the seed with their 16-bit labels (`scene.py`);
`batch` rows a step; each step's augmentation drawn by the program
(`ops/augment.py::draw_augment`) from a `torch.Generator` on the device
seeded from (seed, step), as the port's trainer seeds one a step.
Set-up draws the weights from the seed, runs the `checked_steps` that
the reference follows after the window, then `warmup_steps`; the
window runs steps until its time is up, from a drained device to a
drained device. With --trace 1, CUDA events time each step's batch
call, and torch.profiler covers `profile_steps` steps of the window
from its `profile_from`-th on.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import checks, flops, harness, scene
from benchmark.drivers.serve import device_record, per_layer, torch_seed


def init_weights(state_dict: Dict[str, torch.Tensor], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Weights drawn from the seed on the device in one call: He-normal
    convolutions (fan-in over the input channels and taps), BatchNorm
    scale 1 and shift 0, biases 0, running mean 0 and variance 1."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 20))
    convs = [k for k, v in state_dict.items() if v.ndim == 4]
    flat = torch.randn(sum(state_dict[k].numel() for k in convs),
                       generator=g, device=device)
    out, at = {}, 0
    for k, v in state_dict.items():
        if v.ndim == 4:
            n = v.numel()
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            out[k] = (flat[at:at + n] * (2.0 / fan_in) ** 0.5).reshape(
                v.shape)
            at += n
        elif k.endswith("running_var") or (k.endswith("weight")
                                           and v.ndim == 1):
            out[k] = torch.ones(v.shape, device=device)
        else:
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return out


class Split:
    """One object's training split on the device, and its cache in the
    port's `DeviceDatasetCache` form (no files: the frames are made
    here, the host dataset holds only poses, boxes and intrinsics)."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device):
        from zebrapose_tpu_torch.data.pipeline import (CropDatasetHost,
                                                       DeviceDatasetCache)

        s = cfg["shapes"]
        n = int(tr["frames"])
        with np.load(harness.ROOT / cfg["lut"]) as z:
            pts = torch.as_tensor(z["points"], device=device)
            valid = torch.as_tensor(z["valid"], device=device)
        g = torch.Generator(device=device).manual_seed(torch_seed(seed, 21))
        fr = scene.render(g, n, device, labels=True, lut_points=pts,
                          lut_valid=valid)
        self.arrays = {"rgb": fr["rgb"], "label": fr["label"],
                       "mask": fr["mask"], "entire_mask": fr["mask"]}
        self.bboxes = fr["bbox"].cpu().numpy()
        R, t = fr["R"].cpu().numpy(), fr["t"].cpu().numpy()
        k = scene.K_LMO.reshape(-1).tolist()
        self.dataset_seed = torch_seed(seed, 22)
        ds = CropDatasetHost(
            "", "", [""] * n, [[""]] * n, [[""]] * n,
            [{"cam_R_m2c": R[i].reshape(-1).tolist(),
              "cam_t_m2c": t[i].tolist()} for i in range(n)],
            [{"bbox_visib": [int(v) for v in self.bboxes[i]]}
             for i in range(n)],
            [{"cam_K": k}] * n, is_train=True,
            crop_size_img=s["crop_img"], crop_size_gt=s["crop_gt"],
            padding_ratio=s["padding_ratio"],
            resize_method=s["resize_method"], seed=self.dataset_seed)
        cache = DeviceDatasetCache.__new__(DeviceDatasetCache)
        cache.datasets, cache.offsets = [ds], [0, n]
        cache.image_hw = tuple(s["image_hw"])
        cache.arrays = self.arrays
        cache.nbytes = sum(v.numel() for v in self.arrays.values())
        self.cache = cache


class Trainer:
    """The system under test: model, train state and batch feed as the
    port's `train --from_scratch --bf16 --input_mode device_cache`
    builds them, on weights drawn from the seed."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device,
                 split: Split):
        from zebrapose_tpu_torch.data.pipeline import CachedBatchIterator
        from zebrapose_tpu_torch.models.losses import CodeLossConfig
        from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
        from zebrapose_tpu_torch.train.state import create_train_state

        net, s, t = cfg["network"], cfg["shapes"], cfg["train"]
        self.cfg, self.tr, self.seed, self.dev = cfg, tr, seed, device
        self.split = split
        self.B = int(tr["batch"])
        model = ZebraPoseNet(
            binary_code_length=net["code_bits"], base=net["base"],
            variant=net["variant"], resnet_layers=net["resnet_layers"],
            concat=net["concat_encoder_decoder"],
            output_kernel_size=net["output_kernel_size"])
        self.init = init_weights(model.state_dict(), seed, device)
        model.load_state_dict(self.init)
        model = model.to(device).to(memory_format=torch.channels_last)
        self.state = create_train_state(model.train(), t["learning_rate"],
                                        n_bits=net["code_bits"])
        self.iterator_seed = torch_seed(seed, 23)
        # the host dataset's jitter stream starts anew with each trainer
        split.cache.datasets[0].rng = np.random.default_rng(
            split.dataset_seed)
        self.it = CachedBatchIterator(split.cache, batch_size=self.B,
                                      seed=self.iterator_seed)
        self.loss_cfg = CodeLossConfig(
            loss_type=net["loss_type"], mask_code_loss=t["mask_binary_code_loss"],
            use_histogram_weighting=t["use_histogram_weighted_binary_loss"],
            base=net["base"], n_bits=net["code_bits"])
        self.kw = dict(binary_loss_weight=float(t["binary_loss_weight"]),
                       predict_entire_mask=t["predict_entire_mask"],
                       bf16=t["bf16_autocast"])
        self.pre = dict(crop_img=s["crop_img"], crop_gt=s["crop_gt"],
                        base=net["base"], n_bits=net["code_bits"],
                        resize_method=s["resize_method"],
                        use_pepper_salt=t["use_pepper_salt"],
                        use_motion_blur=t["use_motion_blur"])
        self.k = 0

    def generator(self, k: int) -> torch.Generator:
        """Step k's augmentation generator, seeded from (seed, k)."""
        return torch.Generator(device=self.dev).manual_seed(
            torch_seed(self.seed, 24, k))

    def next_batch(self) -> Dict[str, torch.Tensor]:
        from zebrapose_tpu_torch.data.pipeline import gather_preprocess_batch

        raw = next(self.it)
        return raw, gather_preprocess_batch(
            self.split.cache.arrays, raw["idx"], raw["roi_param"],
            raw["valid"], generator=self.generator(self.k), **self.pre)

    def step(self, batch, fault: Optional[str] = None):
        from zebrapose_tpu_torch.train.train_step import train_step

        if fault == "half":
            # half of the batch left out, the mean taken over the rest
            batch = {k: v[:self.B // 2] for k, v in batch.items()}
        self.k += 1
        return train_step(self.state, batch, self.loss_cfg, **self.kw)

    def checked_steps(self, n: int, fault: Optional[str] = None) -> dict:
        """The first n steps, through the window's own call and feed,
        with what the reference compares: each step's inputs and loss,
        the first step's logits, Adam's first moments after step 1, and
        after step n the parameters, BN statistics and histogram."""
        snap: Dict = {"raw": [], "batches": [], "loss": []}
        params = dict(self.state.model.named_parameters())

        def keep_logits(module, args, out):
            snap["logits_1"] = {k: v.detach().clone() for k, v in out.items()}

        for i in range(n):
            raw, batch = self.next_batch()
            snap["raw"].append(raw)
            snap["batches"].append(batch)
            hook = (self.state.model.register_forward_hook(keep_logits)
                    if i == 0 else None)
            m = self.step(batch, fault)
            if hook is not None:
                hook.remove()
            snap["loss"].append(m["loss_total"].detach())
            if i == 0:
                st = self.state.optimizer.state
                snap["m1"] = {k: st[p]["exp_avg"].clone()
                              for k, p in params.items()
                              if "exp_avg" in st.get(p, {})}
        snap["params"] = {k: p.detach().clone() for k, p in params.items()}
        snap["buffers"] = {k: b.clone() for k, b in
                           self.state.model.named_buffers()
                           if "running" in k}
        snap["histogram"] = self.state.histogram.clone()
        snap["loss"] = [float(x) for x in snap["loss"]]
        return snap


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def train_window(trainer: Trainer, seconds: float, trace: bool,
                 profile_at: Optional[range] = None):
    """Steps until `seconds` have passed (and at least through the
    profiled ones), from a drained device to a drained device. Returns
    (steps, seconds, per-step batch ms, profile)."""
    cuda = trainer.dev.type == "cuda"
    batch_ms: List = []
    prof = None
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    end = t0 + seconds
    i = 0
    while True:
        now = time.perf_counter()
        if now >= end and (profile_at is None or i > profile_at.stop):
            break
        if profile_at is not None and cuda:
            if i == profile_at.start:
                prof = harness.ProfiledSpan()
            elif i == profile_at.stop and prof is not None:
                prof.stop()
        if trace and cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        with _span("bench.batch", trace):
            _, batch = trainer.next_batch()
        if trace and cuda:
            ev[1].record()
            batch_ms.append(ev)
        with _span("bench.step", trace):
            metrics = trainer.step(batch)
        i += 1
    float(metrics["loss_total"])
    if cuda:
        torch.cuda.synchronize()
    seconds_run = time.perf_counter() - t0
    rec = None
    if prof is not None:
        if prof.running:
            prof.stop()
        rec = prof.result
        rec["batches"] = len(profile_at)
    return i, seconds_run, [a.elapsed_time(b) for a, b in batch_ms], rec


def run(cell, seed: int, seconds: float, trace: bool, device,
        process_start: float):
    tr, cfg = cell.traffic, cell.config
    cuda = device.type == "cuda"
    split = Split(cfg, tr, seed, device)
    trainer = Trainer(cfg, tr, seed, device, split)
    snap = trainer.checked_steps(int(tr["checked_steps"]))
    for _ in range(int(tr["warmup_steps"])):
        trainer.step(trainer.next_batch()[1])
    profile_at = None
    if trace:
        p0 = int(tr["profile_from"])
        profile_at = range(p0, p0 + int(tr["profile_steps"]))
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - process_start
    steps, window_s, batch_ms, prof = train_window(trainer, seconds, trace,
                                                   profile_at)
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    result = {"attempted": steps * trainer.B, "failed": 0, "metrics": {},
              "device": device_record(cell, device, mem_peak)}
    units = {m["name"]: m["unit"] for m in cell.end_to_end()}
    if trace:
        run_rec = {"config": cfg, "traffic": tr, "batch": trainer.B,
                   "batch_ms": batch_ms, "profile": prof,
                   "conv_layers": flops.conv_layers(cfg, trainer.B)}
        result["metrics"] = per_layer(cell, run_rec)
        if prof is not None:
            result["device"].update(busy_s=prof["busy_s"],
                                    window_s=prof["window_s"])
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
    else:
        vals = {"train_samples_per_s": steps * trainer.B / window_s,
                "setup_s": setup_s}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in vals.items() if k in units}
    # the program's state goes before the reference runs
    init = trainer.init
    del trainer
    if cuda:
        torch.cuda.empty_cache()
    numbers = checks.train_numbers(cfg, tr, seed, split, init, snap, device)
    judged = checks.judge(numbers, cfg["limits"]["train"])
    result["correct"] = checks.passed(judged)
    return result, judged
