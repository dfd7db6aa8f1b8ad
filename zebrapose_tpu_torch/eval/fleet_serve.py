"""Fleet serving: K per-object models answer in one eval program.

Port of `zebrapose_tpu/eval/fleet_serve.py`. ZebraPose deploys one
network per object; the reference serves a dataset's K objects with K
processes. Here the K models' weights and LUTs are stacked on a leading
model axis (`stack_variables`, `stack_luts`) and each batch of K·B crops
runs as:

  1. one preprocess of all K·B crops (deterministic at eval time),
  2. one forward of the K models, `torch.func.functional_call` vmapped
     over the stacked weights (cuDNN runs each convolution as one
     grouped convolution over the K models),
  3. a loop over the K objects, each the single-object decode
     (`ops/pnp.py::decode_to_pose_batch`) with its own LUT: one launch of
     the EPnP CUDA kernel per object and batch, two with escalation,
     as JAX's lax.scan calls its Pallas kernel unbatched. Each object's
     escalation gate is one host sync, as JAX's lax.cond is one per
     object.

RANSAC draws of object k in the batch at `start` come from
`fleet_generator(seed, start, k)`, the counterpart of JAX's
fold_in(fold_in(key, start), k); object 0's generator is the
single-object path's `batch_generator(seed, start)`. k is the object's
index in the whole fleet, so its poses do not depend on the world.

`run_test_fleet` and `run_vivo_fleet` are the `test-fleet` and
`vivo-fleet` commands on the device (CUDA unless "cpu" is asked for).
With `int8` the members' convs are the int8 serving convs
(`models/layers.py`) and their forwards run in turn
(`make_fleet_eval_step(vmap_forward=False)`): each member's activation
scale is then taken over its own crops, as under JAX's vmap, and the
int8 kernels need no batching rule. `run_test_fleet(debug=True)` writes
each object's debug artifact set under `debug/<obj_name>/`
(`eval/runner.py::dump_debug_set`).

`world=` (`parallel/mesh.py`) is JAX's `mesh=`: the K objects are split
over the ranks, each rank evaluates its K/W objects (rank r the objects
[r·K/W, (r+1)·K/W)), and rank 0 gathers their poses and writes the
per-object CSVs, the merged CSV and the metrics (every rank returns
them). K % W != 0 is refused, as JAX refuses a fleet its mesh does not
divide.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call, vmap

from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
from zebrapose_tpu_torch.data.pipeline import FEED_KEYS, preprocess_batch
from zebrapose_tpu_torch.eval.evaluate import _pad_to, prefetched
from zebrapose_tpu_torch.ops.binarize import code_from_logits, mask_from_logits
from zebrapose_tpu_torch.ops.pnp import (
    PnPConfig,
    RansacDraws,
    decode_to_pose_batch,
)
from zebrapose_tpu_torch.parallel.mesh import (
    World,
    all_gather_object,
    broadcast_object,
)
from zebrapose_tpu_torch.utils.device import resolve_device

def stack_luts(luts: Sequence[CorrespondenceLUT]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """K per-object LUTs -> ([K, C, 3] points, [K, C] valid). All objects
    must share the code space (same base and depth, so the same C)."""
    shapes = {lut.points.shape for lut in luts}
    if len(shapes) > 1:
        raise ValueError(f"fleet LUTs disagree on code space: {shapes}")
    return (np.stack([lut.points for lut in luts]),
            np.stack([lut.valid for lut in luts]))


def stack_variables(state_dicts: Sequence[Dict[str, torch.Tensor]],
                    device=None) -> Dict[str, torch.Tensor]:
    """K per-object state dicts (weights and BN statistics) -> one dict
    of contiguous [K, ...] tensors on `device` (the vmapped forward runs
    NCHW, see `nchw_images`)."""
    dev = resolve_device(device)
    return {k: torch.stack([sd[k].to(dev).contiguous()
                            for sd in state_dicts])
            for k in state_dicts[0]}


def nchw_images(images: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] images laid out NCHW in memory, so the model's
    permute to NCHW gives a contiguous tensor and the vmapped forward runs
    NCHW: under torch.func.vmap, CUDA's batch_norm cannot ask a tensor
    whether it is channels-last."""
    return images.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def model_forward(model: torch.nn.Module, bf16: bool = False) -> Callable:
    """forward_fn(batch, variables) for `make_fleet_eval_step`: `model`
    (in eval mode; its own weights are never read) with one member's
    weights, NCHW (`nchw_images`), under bf16 autocast when asked."""

    def forward(batch, variables):
        x = nchw_images(batch["image"])
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            return functional_call(model, variables, (x,))

    return forward


def fleet_generator(seed: int, start: int, k: int,
                    device) -> torch.Generator:
    """The RANSAC generator of object k in the batch at `start`: seeded
    from (seed, start, k); k = 0 gives `batch_generator(seed, start)`."""
    mixed = ((int(seed) << 32) + int(start)) ^ (
        (int(k) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
    return torch.Generator(device=device).manual_seed(mixed)


def make_fleet_eval_step(forward_fn: Callable, lut_points, lut_valid,
                         crop_img: int, crop_gt: int, base: int,
                         n_bits: int, resize_method: str, loss_type: str,
                         pnp_cfg: PnPConfig, preprocess_gt: bool = False,
                         mask_from_dataset: bool = False,
                         return_masks: bool = False,
                         return_codes: bool = False,
                         vmap_forward: bool = True, device=None):
    """Build step(raw, final_bbox, Ks, variables, generators=None,
    draws=None) -> (R [K,B,3,3], t [K,B,3], success [K,B], n_inliers
    [K,B]) (+ (visible, entire) masks [K,B,h,w] with return_masks,
    + codes [K,B,h,w,n] with return_codes).

    `raw`, `final_bbox` and `Ks` are flat [K·B, ...] in object-major
    order; `variables` is the stacked dict (`stack_variables`);
    forward_fn(batch, variables) is one member's forward (e.g.
    `model_forward`). Object k's RANSAC draws come from draws[k]
    (RansacDraws) when given, else generators[k].
    mask_from_dataset: the Mask-RCNN variant, each detector's mask in
    place of the mask head (and the dataset's entire mask for the
    refinement masks), as the single-object step does. The stacked LUT
    tensors are `step.luts` (points, valid); `luts` replaces them for one
    call (an exported fleet serving module passes its own buffers). With
    `draws` the step traces under `torch.export`. vmap_forward=False runs
    the K members' forwards in turn, each on its slice of the stacked
    weights: a serving artifact does, because the vmapped forward's
    graph does not serialize in every torch (ROADMAP.md C).
    """
    dev = resolve_device(device)
    lp = torch.as_tensor(np.asarray(lut_points), device=dev)
    lv = torch.as_tensor(np.asarray(lut_valid), device=dev)
    k_models = lp.shape[0]

    @torch.no_grad()
    def step(raw, final_bbox, Ks, variables,
             generators: Optional[Sequence[torch.Generator]] = None,
             draws: Optional[Sequence[RansacDraws]] = None,
             luts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        points, valid_lut = luts or (lp, lv)
        raw = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        batch = preprocess_batch(
            raw, crop_img=crop_img, crop_gt=crop_gt, base=base,
            n_bits=n_bits, resize_method=resize_method,
            include_gt=preprocess_gt or mask_from_dataset)
        batch = {k: v.reshape((k_models, -1) + v.shape[1:])
                 for k, v in batch.items()}
        if vmap_forward:
            out = vmap(forward_fn)(batch, variables)
        else:
            outs = [forward_fn({k: v[i] for k, v in batch.items()},
                               {n: v[i] for n, v in variables.items()})
                    for i in range(k_models)]
            out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        out = {k: v.float() for k, v in out.items()}
        if mask_from_dataset:
            masks = (batch["mask"] > 0.5).to(torch.float32)
        else:
            masks = mask_from_logits(out["mask"][..., 0])
        codes = code_from_logits(out["code"], loss_type, base=base)
        valid = raw["valid"].to(torch.float32).reshape(k_models, -1)
        bboxes = torch.as_tensor(final_bbox, device=dev).reshape(
            k_models, -1, 4)
        Kk = torch.as_tensor(Ks, device=dev, dtype=torch.float32).reshape(
            k_models, -1, 3, 3)
        poses = [decode_to_pose_batch(
            masks[i] * valid[i][:, None, None], codes[i], points[i],
            valid_lut[i], bboxes[i], Kk[i], bbox_size=crop_gt, base=base,
            cfg=pnp_cfg,
            generator=None if generators is None else generators[i],
            draws=None if draws is None else draws[i], device=dev)
            for i in range(k_models)]
        result = tuple(torch.stack(x) for x in zip(*poses))
        if return_masks:
            if mask_from_dataset:
                entire = (batch["entire_mask"] > 0.5).to(torch.float32)
            else:
                entire = mask_from_logits(
                    out.get("entire_mask", out["mask"])[..., 0])
            result = result + (masks, entire)
        if return_codes:
            result = result + (codes,)
        return result

    step.luts = (lp, lv)
    return step


def fleet_infer(datasets, fleet_step, variables, batch_size: int,
                seed: int = 0, collect_masks: bool = False,
                collect_codes: bool = False, num_workers: int = 4,
                device=None, first: int = 0,
                draws_for: Optional[Callable[[int], Sequence[RansacDraws]]]
                = None,
                timing: Optional[Dict[str, float]] = None):
    """Drive K per-object datasets through the fleet step in lockstep:
    each batch is one step; short datasets pad with valid = 0 rows
    (whole zero batches once exhausted). Returns per-object lists (Rs,
    ts, ok) of numpy arrays of each dataset's length, plus (visible,
    entire) masks with `collect_masks` and codes with `collect_codes`
    (a step built with return_masks / return_codes).

    Batches are collated ahead on a producer thread (reads on
    `num_workers` threads) and fetched one batch late, as in
    `run_inference`; draws come from `fleet_generator(seed, start,
    first + k)` (`first`: the fleet index of the first dataset's
    object), or from `draws_for(start)` (one RansacDraws an object) when
    given.
    `timing` gets run_inference's keys (inference_s, collate_s, wait_s,
    step_s, fetch_s, and device_s on CUDA)."""
    if collect_codes and not collect_masks:
        raise ValueError("collect_codes requires collect_masks")
    dev = resolve_device(device)
    t_run = time.perf_counter()
    clock = dict.fromkeys(("collate_s", "wait_s", "step_s", "fetch_s"), 0.0)
    spans = []
    k_models = len(datasets)
    lens = [len(d) for d in datasets]
    if any(n == 0 for n in lens):
        raise ValueError(f"empty dataset(s) in fleet walk (lengths {lens})")
    n_max = max(lens)
    Rs = [np.zeros((n, 3, 3), np.float32) for n in lens]
    ts = [np.zeros((n, 3), np.float32) for n in lens]
    ok = [np.zeros((n,), bool) for n in lens]
    n_extra = (2 if collect_masks else 0) + (1 if collect_codes else 0)
    extra = [[[] for _ in lens] for _ in range(n_extra)]
    zero_raw = {}

    def collate(start, pool):
        feeds = []
        for ds, n in zip(datasets, lens):
            idx = list(range(start, min(start + batch_size, n)))
            if idx:
                raw = _pad_to(ds.collate(idx, executor=pool), batch_size)
                if not zero_raw:
                    zero_raw.update({k: np.zeros_like(v)
                                     for k, v in raw.items()})
            else:
                raw = zero_raw           # valid == 0 everywhere: padding
            feeds.append(raw)
        return {k: np.concatenate([f[k] for f in feeds])
                for k in FEED_KEYS + ("final_bbox", "K")}

    def consume(start, out):
        t0 = time.perf_counter()
        host = [x.cpu().numpy() for x in out[:3]]
        more = [x.cpu().numpy() for x in out[4:4 + n_extra]]
        if len(more) < n_extra:
            raise ValueError("collect_masks / collect_codes need a fleet "
                             "step built with return_masks / return_codes")
        for i, n in enumerate(lens):
            m = max(0, min(batch_size, n - start))
            if m:
                Rs[i][start:start + m] = host[0][i, :m]
                ts[i][start:start + m] = host[1][i, :m]
                ok[i][start:start + m] = host[2][i, :m]
                for got, x in zip(extra, more):
                    got[i].extend(x[i, :m])
        clock["fetch_s"] += time.perf_counter() - t0

    pending = None
    with prefetched(collate, range(0, n_max, batch_size), num_workers,
                    clock) as batches:
        for start, cat in batches:
            kw = ({"draws": draws_for(start)} if draws_for is not None
                  else {"generators": [
                      fleet_generator(seed, start, first + k, dev)
                      for k in range(k_models)]})
            t0 = time.perf_counter()
            if dev.type == "cuda":
                spans.append((torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True)))
                spans[-1][0].record()
            out = fleet_step({k: cat[k] for k in FEED_KEYS},
                             cat["final_bbox"].astype(np.int32), cat["K"],
                             variables, **kw)
            if spans:
                spans[-1][1].record()
            clock["step_s"] += time.perf_counter() - t0
            if pending is not None:
                consume(*pending)
            pending = (start, out)
        if pending is not None:
            consume(*pending)
    if timing is not None:
        timing.update(clock, inference_s=time.perf_counter() - t_run)
        if spans:
            timing["device_s"] = sum(a.elapsed_time(b)
                                     for a, b in spans) / 1e3
    return (Rs, ts, ok) + tuple([np.array(x) for x in got]
                                for got in extra)


def _fleet_model(cfg, variant: str, ckpt_files: Sequence[str], dev,
                 quant=False):
    """The members' architecture (on the meta device: functional_call
    never reads its weights; `quant` its convs' int8 mode) in eval mode,
    and their stacked weights."""
    from zebrapose_tpu_torch.eval.runner import load_model_variables
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet

    with torch.device("meta"):
        model = ZebraPoseNet(
            binary_code_length=cfg.number_of_itration,
            base=cfg.divide_number_each_itration, variant=variant,
            resnet_layers=cfg.resnet_layer,
            concat=cfg.concat_encoder_decoder,
            output_kernel_size=cfg.output_kernel_size, quant=quant).eval()
    shapes = {n: t.shape for n, t in model.state_dict().items()}
    names = set(shapes)
    # one name a tensor: the state dict also holds the `resnet_layer_*`
    # aliases, which functional_call takes as tied
    keep = [n for n, _ in model.named_parameters()] + \
        [n for n, _ in model.named_buffers()]
    sds = []
    for ck in ckpt_files:
        sd = load_model_variables(
            ck, variant, resnet_layers=cfg.resnet_layer,
            nonbinary=cfg.divide_number_each_itration != 2)
        if set(sd) != names:
            raise ValueError(
                f"checkpoint {ck!r} does not hold the {variant} model's "
                f"weights: missing {sorted(names - set(sd))[:5]}, "
                f"unexpected {sorted(set(sd) - names)[:5]}")
        # the model's shapes (a compact checkpoint's BN step count is
        # [1], a .pth's a scalar), so members from both formats stack
        sds.append({n: sd[n].reshape(shapes[n]) for n in keep})
    return model, stack_variables(sds, dev)


def _fleet_step(cfg, model, lp, lv, pnp_cfg, mask_rcnn: bool,
                return_masks: bool, dev, int8: bool = False,
                return_codes: bool = False):
    return make_fleet_eval_step(
        model_forward(model), lp, lv,
        crop_img=cfg.BoundingBox_CropSize_image,
        crop_gt=cfg.BoundingBox_CropSize_GT,
        base=cfg.divide_number_each_itration,
        n_bits=cfg.number_of_itration, resize_method=cfg.resize_method,
        loss_type=cfg.BinaryCode_Loss_Type, pnp_cfg=pnp_cfg or PnPConfig(),
        mask_from_dataset=mask_rcnn, return_masks=return_masks,
        return_codes=return_codes, vmap_forward=not int8, device=dev)


def _world_rows(world: Optional[World], k: int, dev) -> Tuple[World,
                                                              range]:
    """The world (one process on `dev` when None) and the objects its
    rank evaluates; refuses K % W != 0."""
    world = world or World(device=dev)
    if k % world.size:
        raise ValueError(
            f"fleet size {k} not divisible by world size {world.size}; "
            f"serve K%W==0 objects or run fewer ranks")
    per = k // world.size
    return world, range(world.rank * per, (world.rank + 1) * per)


def _gather_rows(out: tuple, world: World) -> tuple:
    """Each rank's fleet_infer lists (one entry an object), concatenated
    in rank order (the fleet's object order)."""
    parts = all_gather_object(out, world)
    return tuple(sum((list(p[j]) for p in parts), [])
                 for j in range(len(out)))


def _share_slice_buffer(datasets) -> None:
    """Lockstep batches stack across objects, so every dataset emits one
    roi_slice buffer shape: the fleet-wide max of their naturals."""
    naturals = [ds.natural_slice_hw() for ds in datasets]
    hw = (max(h for h, _ in naturals), max(w for _, w in naturals))
    for ds in datasets:
        ds.set_slice_hw(hw)


def run_test_fleet(cfg, obj_names: List[str], ckpt_files: List[str],
                   output_dir: str, variant: str = "v2",
                   batch_size: int = 16,
                   pnp_cfg: Optional[PnPConfig] = None,
                   int8: bool = False, max_samples: Optional[int] = None,
                   mask_rcnn: bool = False, roi_slice: bool = False,
                   debug: bool = False, device=None,
                   world: Optional[World] = None) -> dict:
    """Evaluate K objects with one fleet step a batch (the fleet `test`):
    per-object datasets advance in lockstep, and each object gets its
    BOP CSV and ADD / ADD-S metrics, plus one merged submission CSV
    `<output_dir>/<dataset>_fleet.csv`. cfg.refine runs the host contour
    refinement per object on the fleet's own masks (`refine_poses`), as
    `run_test` does; mask_rcnn takes each object's detector RLE in place
    of its mask head; roi_slice imposes the fleet-wide max buffer; int8
    runs the int8 serving convs (module docstring). debug writes each
    object's artifact set (mask panel, code-error grid, pose outlines;
    reference test.py:315-441) under `debug/<obj_name>/` and its
    refiner's frames under `debug/<obj_name>/refine`, as `run_test
    --debug` does for one object. Prints a `timing {...}` line (seconds
    by stage). `world`: the objects split over its ranks (module
    docstring); the device is then the rank's."""
    from zebrapose_tpu_torch.data import bop_io
    from zebrapose_tpu_torch.data.bop_writer import (
        merge_csv,
        parse_sample_ids,
        write_csv,
    )
    from zebrapose_tpu_torch.eval.evaluate import pose_errors, summarize
    from zebrapose_tpu_torch.eval.runner import (
        dataset_image_hw,
        dump_debug_set,
        prepare_object_eval,
        refine_poses,
    )

    if len(ckpt_files) != len(obj_names):
        raise ValueError("need one checkpoint per object")
    dev = world.device if world is not None else resolve_device(device)
    world, rows = _world_rows(world, len(obj_names), dev)
    t0 = time.perf_counter()
    # the non-challenge walk does not depend on the object: walk once
    shared = None if cfg.bop_challange else bop_io.get_dataset(
        cfg.bop_path, cfg.dataset_name, train=False, eval_model=True,
        data_folder=cfg.test_folder)
    oes = [prepare_object_eval(cfg, n, max_samples=max_samples,
                               mask_rcnn=mask_rcnn, roi_slice=roi_slice,
                               samples=shared) for n in obj_names]
    for n, oe in zip(obj_names, oes):
        if len(oe.dataset) == 0:
            raise ValueError(f"object {n}: empty eval split")
    if roi_slice:
        _share_slice_buffer([oe.dataset for oe in oes])
    t1 = time.perf_counter()
    model, variables = _fleet_model(
        cfg, variant, [ckpt_files[i] for i in rows], dev, int8)
    lp, lv = stack_luts([oes[i].lut for i in rows])
    step = _fleet_step(cfg, model, lp, lv, pnp_cfg, mask_rcnn,
                       cfg.refine or debug, dev, int8, return_codes=debug)
    t2 = time.perf_counter()

    timing: Dict[str, float] = {}
    out = _gather_rows(fleet_infer(
        [oes[i].dataset for i in rows], step, variables, batch_size,
        collect_masks=cfg.refine or debug, collect_codes=debug,
        device=dev, timing=timing, first=rows.start), world)
    if not world.is_main:
        return broadcast_object(None, world)
    Rs, ts, ok = out[:3]
    t3 = time.perf_counter()
    os.makedirs(output_dir, exist_ok=True)
    per_object, csvs, refined = {}, [], 0
    for i, (name, oe) in enumerate(zip(obj_names, oes)):
        if cfg.refine and "faces" in oe.mesh:
            refined += refine_poses(
                oe.dataset, Rs[i], ts[i], ok[i], out[3][i], out[4][i],
                oe.vertices, oe.mesh["faces"].astype(np.int32),
                dataset_image_hw(oe.samples, oe.dataset),
                cfg.BoundingBox_CropSize_GT,
                debug_dir=(os.path.join(output_dir, "debug", name, "refine")
                           if debug else None))
        if debug:
            dump_debug_set(os.path.join(output_dir, "debug", name), cfg,
                           oe.dataset, oe.mesh, oe.vertices, out[3][i],
                           out[5][i], Rs[i], ts[i], ok[i])
        Rs[i][~ok[i]] = np.eye(3)       # reference: identity R / zero t
        ts[i][~ok[i]] = 0
        errors = pose_errors(oe.dataset, Rs[i], ts[i], ok[i], oe.vertices,
                             oe.symmetric, device=dev)
        per_object[name] = summarize(errors, oe.diameter,
                                     "ADD-S" if oe.symmetric else "ADD")
        ids = parse_sample_ids(oe.dataset.rgb_files)
        csvs.append(write_csv(
            os.path.join(output_dir, "pose_result_bop"),
            f"{cfg.dataset_name}_{name}", oe.obj_id,
            [s for s, _ in ids], [im for _, im in ids], list(Rs[i]),
            [t.reshape(3, 1) for t in ts[i]],
            oe.scores if oe.scores is not None else [1.0] * len(ts[i])))
    merged = merge_csv(csvs, os.path.join(
        output_dir, f"{cfg.dataset_name}_fleet.csv"))
    timing.update(prepare_s=t1 - t0, load_model_s=t2 - t1,
                  finish_s=time.perf_counter() - t3)
    if cfg.refine:
        timing["refined"] = refined
    # where this run's time went, in seconds (fleet_infer's stages;
    # finish_s: refinement, pose errors and the CSVs)
    print("timing " + json.dumps(timing))
    return broadcast_object({"per_object": per_object,
                             "merged_csv": merged}, world)


def run_vivo_fleet(cfg, obj_names: List[str], ckpt_files: List[str],
                   output_dir: str, variant: str = "v2",
                   score_threshold: float = 0.2, batch_size: int = 16,
                   pnp_cfg: Optional[PnPConfig] = None,
                   int8: bool = False, mask_rcnn: bool = False,
                   roi_slice: bool = False, device=None,
                   world: Optional[World] = None) -> dict:
    """Multi-instance (vivo) evaluation of K objects with one fleet step
    a batch: each object's detected instances above `score_threshold`
    form its dataset (`eval/vivo.py`), all K advance in lockstep, and
    each object's CSV carries the detector scores (failed instances
    score -1 and are dropped), plus one merged submission CSV
    `<output_dir>/<dataset>_vivo_fleet.csv`. Objects without a detection
    are skipped with a warning (instances 0); int8 and `world` as in
    `run_test_fleet` (K: the objects with detections). Prints a `timing
    {...}` line."""
    from zebrapose_tpu_torch.codec.lut import load_correspondence_lut
    from zebrapose_tpu_torch.data import bop_io
    from zebrapose_tpu_torch.data import detections as det_mod
    from zebrapose_tpu_torch.data.bop_writer import (
        merge_csv,
        parse_sample_ids,
        write_csv,
    )
    from zebrapose_tpu_torch.data.dataset_info import lookup_obj_id
    from zebrapose_tpu_torch.eval.vivo import build_vivo_dataset

    if len(ckpt_files) != len(obj_names):
        raise ValueError("need one checkpoint per object")
    dev = world.device if world is not None else resolve_device(device)
    t0 = time.perf_counter()
    rgb_files, cam_by_file = bop_io.list_images_with_cameras(
        cfg.bop_path, cfg.dataset_name, data_folder=cfg.test_folder)
    dataset_dir = os.path.join(cfg.bop_path, cfg.dataset_name)
    dets = det_mod.load_detections(cfg.Detection_reaults)

    per_object = {}
    live = []  # (name, ckpt file, obj_id, dataset, scores)
    for name, ck in zip(obj_names, ckpt_files):
        obj_id = lookup_obj_id(cfg.dataset_name, name)
        dataset, scores = build_vivo_dataset(
            dataset_dir, cfg.test_folder, rgb_files, cam_by_file, dets,
            obj_id, score_threshold,
            crop_size_img=cfg.BoundingBox_CropSize_image,
            crop_size_gt=cfg.BoundingBox_CropSize_GT,
            padding_ratio=cfg.padding_ratio,
            resize_method=cfg.resize_method,
            use_segmentation=mask_rcnn, roi_slice=roi_slice)
        if len(dataset) == 0:
            if world is None or world.is_main:
                print(f"WARNING: {name}: no detection above score "
                      f"{score_threshold} in the split; skipped from the "
                      "fleet")
            per_object[name] = {"instances": 0, "solved": 0,
                                "solve_rate": 0.0}
            continue
        live.append((name, ck, obj_id, dataset, scores))
    if not live:
        raise ValueError("no object has any detected instance")
    if roi_slice:
        _share_slice_buffer([ds for _, _, _, ds, _ in live])
    world, rows = _world_rows(world, len(live), dev)
    mine = [live[i] for i in rows]
    t1 = time.perf_counter()
    model, variables = _fleet_model(cfg, variant,
                                    [ck for _, ck, _, _, _ in mine], dev,
                                    int8)
    lp, lv = stack_luts([load_correspondence_lut(os.path.join(
        dataset_dir, "models_GT_color", f"Class_CorresPoint{oid:06d}.txt"))
        for _, _, oid, _, _ in mine])
    step = _fleet_step(cfg, model, lp, lv, pnp_cfg, mask_rcnn, False, dev,
                       int8)
    t2 = time.perf_counter()

    timing: Dict[str, float] = {}
    Rs, ts, ok = _gather_rows(fleet_infer(
        [ds for _, _, _, ds, _ in mine], step, variables, batch_size,
        device=dev, timing=timing, first=rows.start), world)
    if not world.is_main:
        return broadcast_object(None, world)
    t3 = time.perf_counter()
    os.makedirs(output_dir, exist_ok=True)
    csvs = []
    for i, (name, _, obj_id, dataset, scores) in enumerate(live):
        out_scores = [s if k else -1 for s, k in zip(scores, ok[i])]
        ids = parse_sample_ids(dataset.rgb_files)
        csvs.append(write_csv(
            os.path.join(output_dir, "pose_result_bop"),
            f"{cfg.dataset_name}_{name}", obj_id,
            [s for s, _ in ids], [im for _, im in ids],
            list(Rs[i]), [t.reshape(3, 1) for t in ts[i]], out_scores))
        per_object[name] = {"instances": len(dataset),
                            "solved": int(np.sum(ok[i])),
                            "solve_rate": float(np.mean(ok[i]))}
    merged = merge_csv(csvs, os.path.join(
        output_dir, f"{cfg.dataset_name}_vivo_fleet.csv"))
    timing.update(prepare_s=t1 - t0, load_model_s=t2 - t1,
                  finish_s=time.perf_counter() - t3)
    print("timing " + json.dumps(timing))
    return broadcast_object({"per_object": per_object,
                             "merged_csv": merged}, world)
