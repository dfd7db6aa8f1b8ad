"""Command line of the port: the reference's train, test and BOP commands.

  python -m zebrapose_tpu_torch train --cfg cfg.txt --obj_name ape \
      [--from_scratch | --pretrained_backbone resnet34.pth] [--bf16] \
      [--qat] [--max_steps N] [--log_freq N] [--cache_images] \
      [--input_mode stream|prefetch|device_cache] [--multihost] \
      [--device cuda|cpu]
  python -m torch.distributed.run --nproc_per_node N -m zebrapose_tpu_torch \
      train ...              (data parallel: one process a card)
  python -m zebrapose_tpu_torch test --cfg cfg.txt --obj_name ape \
      --ckpt_file <.npz or .pth> [--batch_size N] [--escalate_h 256] \
      [--int8] [--debug] [--device cuda|cpu]
  python -m zebrapose_tpu_torch visualize --cfg cfg.txt --obj_name ape \
      --ckpt_file <.npz or .pth> --scene 2 --im 0 [--device cuda|cpu]
  python -m zebrapose_tpu_torch vivo --cfg cfg.txt --obj_name ape \
      --ckpt_file <.npz or .pth> [--score_threshold 0.2] [--batch_size N] \
      [--mask_rcnn] [--roi_slice] [--escalate_h 256] [--int8] \
      [--device cuda|cpu]
  python -m zebrapose_tpu_torch score-bop --csv sub.csv --bop_path DIR \
      --dataset lmo [--split test] [--no_vsd] [--device cuda|cpu]
  python -m zebrapose_tpu_torch merge-csv a.csv b.csv --out all.csv
  python -m zebrapose_tpu_torch generate-mesh-code --mesh obj.ply -d 2 \
      -n 16 --corres_txt Class_CorresPoint000001.txt [--colored_ply c.ply]
  python -m zebrapose_tpu_torch generate-labels --cfg cfg.txt \
      --obj_name ape [--data_folder train_pbr] [--force]
  python -m zebrapose_tpu_torch train-fleet --cfg cfg.txt \
      --obj_names ape can [--from_scratch] [--bf16] [--max_steps N] \
      [--log_freq N] [--device cuda|cpu]
  python -m torch.distributed.run --nproc_per_node N -m zebrapose_tpu_torch \
      train-fleet ...        (the members spread over the cards)
  python -m zebrapose_tpu_torch test-fleet --cfg cfg.txt \
      --obj_names ape can --ckpt_files a.pth b.pth [--batch_size N] \
      [--mask_rcnn] [--roi_slice] [--escalate_h 256] [--int8] [--debug] \
      [--device cuda|cpu]
  python -m zebrapose_tpu_torch vivo-fleet --cfg cfg.txt \
      --obj_names ape can --ckpt_files a.pth b.pth [--score_threshold 0.2] \
      [--batch_size N] [--mask_rcnn] [--roi_slice] [--int8] \
      [--device cuda|cpu]
  python -m zebrapose_tpu_torch export-serving --cfg cfg.txt --obj_name ape \
      --ckpt_file <.npz or .pth> --out ape.serving [--batch 64 | 0] \
      [--image_h 480 --image_w 640] [--f32] [--int8] [--roi_slice] \
      [--n_hypotheses 128] [--max_points 4096] [--device cuda|cpu]
  python -m zebrapose_tpu_torch serve-exported --cfg cfg.txt --obj_name ape \
      --blob ape.serving [--vivo] [--batch_size N] [--seed 0] \
      [--device cuda|cpu]
  python -m zebrapose_tpu_torch export-serving-fleet --cfg cfg.txt \
      --obj_names ape can --ckpt_files a.pth b.pth --out fleet.serving \
      [--batch 16] [--f32] [--int8] [--device cuda|cpu]
  python -m zebrapose_tpu_torch serve-exported-fleet --cfg cfg.txt \
      --obj_names ape can --blob fleet.serving [--vivo] [--device cuda|cpu]
  python -m zebrapose_tpu_torch export-ckpt --ckpt_file <.npz or .pth> \
      --out ref.pth [--variant v2] [--resnet_layers 34] [--base 2]
  python -m zebrapose_tpu_torch model-cost [--variant v2] \
      [--resnet_layers 34] [--code_length 16] [--crop 256] [--no_concat] \
      [--device cuda|cpu]

The flags are those of `python -m zebrapose_tpu train` / `test` /
`vivo` / `score-bop` plus `--device` (default cuda; without CUDA a
command fails unless `--device cpu` is given). `train` writes
`<output_dir>/<dataset>_<obj>/checkpoints/` (reference-format .pth files
that `test` loads) and `logs/metrics.jsonl`; `--qat` trains through the
fake-quant convs, and the checkpoint loads unchanged into `--int8`;
`--input_mode prefetch` copies each batch to the card one step ahead on
a side stream, `device_cache` uploads the training splits' pixels once
and gathers each batch on the card (`data/pipeline.py`). Under torchrun
(`python -m torch.distributed.run --nproc_per_node N`, one process a
card, cuda:LOCAL_RANK) `train` is data parallel over the N cards
(`parallel/mesh.py`: BatchNorm statistics, the histogram and the
metrics over the global batch, lr × N and iterations ÷ N) and
`train-fleet` gives each rank its share of the K members (the fleet
padded to a multiple of N with ghost rows); `--multihost` joins the
torchrun world across nodes, and fails without one. Only rank 0 prints,
logs and writes checkpoints. `test --debug` writes the
reference's debug artifacts (mask panels, code-error grids, pose
outlines; `utils/visualize.py`) under `<run dir>/debug`, and
`visualize` does so for one frame (`--scene`, `--im`). `--int8` on
`test`, `vivo`, `test-fleet`, `vivo-fleet`, `export-serving` and
`export-serving-fleet` runs the convs above the int8 gate on the int8
CUDA kernels (`ops/int8_conv.py`; the plain versions with `--device
cpu`). `vivo` (the BOP-challenge
multi-instance protocol over detections) writes the submission CSV that
`score-bop` scores (BOP19 AR_vsd / AR_mssd / AR_mspd; the result is
printed as JSON). The config file is the reference's flat `key = value`
format. `generate-mesh-code` (a mesh's hierarchical surface code:
`Class_CorresPoint*.txt` and the colored mesh) and `generate-labels` (the
`<split>_GT_v2` label images of one object over a BOP split, writing the
surface code first when it is absent) are host work in both stacks:
numpy and the port's C++ library (`native/`). They take no `--device` and
touch no tensor on any device; the JAX package's commands never reach an
accelerator either, so this is not a CPU fallback. `train-fleet`,
`test-fleet` and `vivo-fleet` are the fleet commands: K objects' models
in one program (`train/fleet.py`, `eval/fleet_serve.py`), each member
writing the single-object command's files under its own name and the
evaluations one merged submission CSV; `test-fleet --debug` writes each
object's debug artifacts under `debug/<obj_name>/`. `export-serving` and
`export-serving-fleet` write the eval program of one object or of K
objects, weights and LUT included, as one `torch.export` artifact
(`eval/export_serving.py`) bound to the device it was traced on;
`serve-exported [--vivo]` and `serve-exported-fleet [--vivo]` answer a
split from such an artifact alone and write the CSVs of `test` / `vivo`
/ `test-fleet` / `vivo-fleet`. Their `--platforms` and `--pallas` are
refused: a torch.export program runs on the device it was exported on,
and the EPnP kernel goes with that device. `export-ckpt` writes a
checkpoint (`.npz` or `.pth`) as the reference's `.pth` dict
(`models/convert.py::save_reference_checkpoint`) and strict-loads the
file into the model on `--device`; orbax directories are refused by
design. `model-cost`
prints the model's parameters and one eval forward's FLOPs at batch 1
(`torch.utils.flop_counter`: matmuls and convolutions, where the JAX
package's XLA count also has elementwise ops) as the JAX package's
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _add_pnp_flags(p):
    p.add_argument("--escalate_h", type=int, default=0,
                   help="adaptive RANSAC second stage: redraw with this "
                        "many hypotheses when a frame's inlier fraction is "
                        "weak (0 = off)")
    p.add_argument("--escalate_frac", type=float, default=0.4,
                   help="inlier fraction below which the second RANSAC "
                        "stage triggers")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")


def _pnp_cfg_from_args(args):
    from zebrapose_tpu_torch.ops.pnp import PnPConfig
    kw = {}
    if args.escalate_h:
        kw["escalate_hypotheses"] = args.escalate_h
        kw["escalate_inlier_frac"] = args.escalate_frac
    return PnPConfig(**kw)


_INT8_HELP = ("int8 conv compute: per-channel weight and dynamic "
              "per-tensor activation quantization of the convs above the "
              "gate, int32 accumulation (the int8 CUDA kernels)")


def _add_train(sub):
    p = sub.add_parser("train", help="train one object (train_v2)")
    p.add_argument("--cfg", required=True, help="reference-format config")
    p.add_argument("--obj_name", required=True)
    p.add_argument("--output_dir", default="runs")
    p.add_argument("--variant", default="v2", choices=["v1", "v2", "v3"])
    p.add_argument("--pretrained_backbone", default="auto",
                   help="torchvision resnet34 .pth; 'auto' searches known "
                        "locations and fails if absent (the reference "
                        "always trains from ImageNet weights)")
    p.add_argument("--from_scratch", action="store_true",
                   help="train from random init")
    p.add_argument("--gamma", type=float, default=1.0,
                   help="StepLR decay per 10 validation cadences (1.0 = "
                        "train_v2/v5, 0.7 = train_v3)")
    p.add_argument("--val_mode", default="pose", choices=["pose", "loss"],
                   help="pose = decode->PnP->recall with best checkpoint "
                        "(train_v2); loss = loss-only validation (train_v6)")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--log_freq", type=int, default=1000)
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace (trace.json) "
                        "to this dir")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 autocast of the forward (parameters, "
                        "optimizer and losses stay f32)")
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware training: the convs above the "
                        "int8 gate run the differentiable int8 simulation "
                        "(STE); the checkpoint serves with --int8 "
                        "(typically a short fine-tune of a float "
                        "checkpoint)")
    p.add_argument("--multihost", action="store_true",
                   help="join the torchrun world (torch.distributed: NCCL "
                        "on CUDA, gloo on the CPU) for multi-node data "
                        "parallel training; fails without one")
    p.add_argument("--input_mode", default="stream",
                   choices=["stream", "prefetch", "device_cache"],
                   help="stream = host MixedBatchIterator (default); "
                        "prefetch = copy each batch to the device one step "
                        "ahead on a side stream; device_cache = upload the "
                        "training splits' pixels to the device once and "
                        "gather each batch there (~2.46 MB a 480x640 "
                        "sample: for per-object real splits, not 50k PBR "
                        "trees)")
    p.add_argument("--cache_images", action="store_true",
                   help="hold decoded full-res frames in host RAM")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: split each optimizer "
                        "step's batch (cfg.batch_size) into this many "
                        "micro-batches")
    p.add_argument("--gt_labels", default="v2", choices=["v1", "v2"],
                   help="GT label directory: v2 = <split>_GT_v2, v1 = "
                        "<split>_GT")
    _add_device(p)


def _world(args, multihost: bool = False):
    """The command's data-parallel world and whether the command joined
    its process group (and leaves it at the end): `--multihost` joins
    the torchrun world and fails without one; otherwise the torchrun
    world when there is one, else one process on `--device`."""
    import torch.distributed as dist

    from zebrapose_tpu_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
    )

    joined = not dist.is_initialized()
    world = initialize_multihost(device=args.device) if multihost \
        else make_mesh(args.device)
    if dist.is_initialized() and world.is_main:
        print(f"world: {world.size} rank(s) over {world.backend}, rank 0 "
              f"on {world.device}")
    return world, joined and dist.is_initialized()


def _train(args) -> int:
    from zebrapose_tpu_torch.parallel.mesh import shutdown

    world, joined = _world(args, args.multihost)
    try:
        return _train_in(args, world)
    finally:
        if joined:
            shutdown()


def _train_in(args, world) -> int:
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.train.trainer import build_train_setup, fit
    from zebrapose_tpu_torch.utils.profiling import profile_trace

    cfg = ZebraConfig.from_file(args.cfg)
    out = os.path.join(args.output_dir, f"{cfg.dataset_name}_{args.obj_name}")
    res = build_train_setup(
        cfg, args.obj_name, out, variant=args.variant,
        pretrained_backbone=(None if args.from_scratch
                             else args.pretrained_backbone),
        bf16=args.bf16, qat=args.qat, gamma=args.gamma,
        log_freq=args.log_freq, cache_images=args.cache_images,
        accum_steps=args.accum_steps,
        gt_dir_suffix="_GT" if args.gt_labels == "v1" else "_GT_v2",
        device_cache=args.input_mode == "device_cache",
        device_prefetch=args.input_mode == "prefetch", world=world)
    timing = {}
    try:
        with profile_trace(args.profile if world.is_main else None):
            best = fit(res, log_freq=args.log_freq, max_steps=args.max_steps,
                       val_mode=args.val_mode, timing=timing)
        # where this run's time went, in seconds (fit's stages)
        res.logger.log(res.state.step, timing, prefix="timing/")
    finally:
        res.ckpt.close()
        res.logger.close()
    if world.is_main:
        print(f"best val recall: {best}")
    return 0


def _add_fleet(sub):
    p = sub.add_parser(
        "train-fleet",
        help="train K objects at once, one model per object, in one "
             "program (the reference runs one process per object)")
    p.add_argument("--cfg", required=True,
                   help="reference-format config (shared)")
    p.add_argument("--obj_names", required=True, nargs="+",
                   help="the K objects")
    p.add_argument("--output_dir", default="runs")
    p.add_argument("--variant", default="v2", choices=["v1", "v2", "v3"])
    p.add_argument("--pretrained_backbone", default="auto")
    p.add_argument("--from_scratch", action="store_true")
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--log_freq", type=int, default=1000)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--cache_images", action="store_true")
    _add_device(p)

    for name, what in (("test-fleet", "evaluate K objects with one fleet "
                        "program (per-object CSV + metrics, one merged "
                        "submission CSV)"),
                       ("vivo-fleet", "multi-instance eval of K objects "
                        "with one fleet program")):
        p = sub.add_parser(name, help=what)
        p.add_argument("--cfg", required=True)
        p.add_argument("--obj_names", required=True, nargs="+")
        p.add_argument("--ckpt_files", required=True, nargs="+",
                       help="one checkpoint (.npz or .pth) per object")
        p.add_argument("--output_dir", default="eval_out")
        p.add_argument("--variant", default="v2",
                       choices=["v1", "v2", "v3"])
        if name == "vivo-fleet":
            p.add_argument("--score_threshold", type=float, default=0.2)
        p.add_argument("--batch_size", type=int, default=16)
        if name == "test-fleet":
            p.add_argument("--max_samples", type=int, default=None)
        p.add_argument("--int8", action="store_true",
                       help=_INT8_HELP)
        p.add_argument("--mask_rcnn", action="store_true",
                       help="each object's detector RLE segmentation "
                            "instead of its mask head")
        p.add_argument("--roi_slice", action="store_true",
                       help="ship only each frame's clamped square-bbox "
                            "bytes (a fleet-wide buffer; bit-exact crops)")
        if name == "test-fleet":
            p.add_argument("--debug", action="store_true",
                           help="write the per-sample debug artifact set "
                                "under debug/<obj_name>/ (reference "
                                "test.py:315-441), as `test --debug` does")
        _add_pnp_flags(p)
        _add_device(p)


def _train_fleet(args) -> int:
    from zebrapose_tpu_torch.parallel.mesh import shutdown

    world, joined = _world(args)
    try:
        return _train_fleet_in(args, world)
    finally:
        if joined:
            shutdown()


def _train_fleet_in(args, world) -> int:
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.train.fleet import build_fleet_setup, fit_fleet

    cfg = ZebraConfig.from_file(args.cfg)
    fleet = build_fleet_setup(
        cfg, args.obj_names, os.path.join(args.output_dir,
                                          cfg.dataset_name),
        variant=args.variant,
        pretrained_backbone=(None if args.from_scratch
                             else args.pretrained_backbone),
        bf16=args.bf16, gamma=args.gamma, log_freq=args.log_freq,
        cache_images=args.cache_images, world=world)
    timing = {}
    try:
        best = fit_fleet(fleet, log_freq=args.log_freq,
                         max_steps=args.max_steps, timing=timing)
        # where this run's time went, in seconds (fit_fleet's stages)
        for m in fleet.members:
            m.logger.log(fleet.state.step, timing, prefix="timing/")
    finally:
        for m in fleet.members:
            m.ckpt.close()
            m.logger.close()
    if world.is_main:
        for name, b in zip(args.obj_names, best):
            print(f"{name}: best val recall {b}")
    return 0


def _eval_fleet(args, device) -> int:
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.eval import fleet_serve
    from zebrapose_tpu_torch.utils.logging import TeeOutput, prepare_eval_dir

    cfg = ZebraConfig.from_file(args.cfg)
    items = dict(cfg.to_dict())
    items.update({"obj_names": " ".join(args.obj_names),
                  "checkpoint_files": " ".join(args.ckpt_files),
                  "command": args.command, "device": str(device)})
    run_dir = prepare_eval_dir(args.output_dir, items)
    kw = dict(variant=args.variant, batch_size=args.batch_size,
              int8=args.int8, mask_rcnn=args.mask_rcnn,
              roi_slice=args.roi_slice, pnp_cfg=_pnp_cfg_from_args(args),
              device=device)
    with TeeOutput(os.path.join(run_dir, "log.txt")):
        print(f"eval run dir: {run_dir}")
        if args.command == "test-fleet":
            res = fleet_serve.run_test_fleet(
                cfg, args.obj_names, args.ckpt_files, run_dir,
                max_samples=args.max_samples, debug=args.debug, **kw)
        else:
            res = fleet_serve.run_vivo_fleet(
                cfg, args.obj_names, args.ckpt_files, run_dir,
                score_threshold=args.score_threshold, **kw)
        print(json.dumps(res, indent=2))
    return 0


def _add_serving(sub):
    p = sub.add_parser(
        "export-serving",
        help="export the eval program (preprocess + forward + decode + "
             "EPnP-RANSAC) of one object as one torch.export artifact "
             "with the weights and the LUT in it")
    p.add_argument("--cfg", required=True, help="reference-format config")
    p.add_argument("--obj_name", required=True)
    p.add_argument("--ckpt_file", required=True,
                   help="compact .npz or reference-format .pth")
    p.add_argument("--ignore_bit", type=int, default=0)
    p_fleet = sub.add_parser(
        "export-serving-fleet",
        help="export K per-object models as ONE serving artifact (the "
             "fleet program: stacked weights + LUTs, one vmapped forward, "
             "per-object decode)")
    p_fleet.add_argument("--cfg", required=True)
    p_fleet.add_argument("--obj_names", required=True, nargs="+")
    p_fleet.add_argument("--ckpt_files", required=True, nargs="+")
    for q, batch in ((p, 64), (p_fleet, 16)):
        q.add_argument("--out", required=True, help="output blob path")
        q.add_argument("--batch", type=int, default=batch,
                       help="per-object batch; 0 = symbolic (one blob "
                            "serves any batch size)")
        q.add_argument("--image_h", type=int, default=480)
        q.add_argument("--image_w", type=int, default=640)
        q.add_argument("--variant", default="v2",
                       choices=["v1", "v2", "v3"])
        q.add_argument("--int8", action="store_true",
                       help="bake the int8 serving convs into the "
                            "artifact (" + _INT8_HELP + ")")
        q.add_argument("--n_hypotheses", type=int, default=128,
                       help="RANSAC hypothesis count baked into the blob")
        q.add_argument("--max_points", type=int, default=4096,
                       help="correspondence subset capacity baked in")
        q.add_argument("--f32", action="store_true",
                       help="f32 model compute (default bf16, the "
                            "production serving dtype; `test` evaluates "
                            "in f32: export --f32 to reproduce its CSV)")
        q.add_argument("--roi_slice", action="store_true",
                       help="export for ROI-sliced input buffers: frame "
                            "dims from the configured test walk's max "
                            "padded bbox (override --image_h/--image_w)")
        q.add_argument("--platforms", nargs="+", default=None,
                       help="refused: a torch.export program runs on the "
                            "device it was exported on (--device)")
        q.add_argument("--pallas", default=None,
                       choices=["auto", "on", "off"],
                       help="refused: the artifact runs the EPnP kernel "
                            "of its device")
        _add_device(q)

    p = sub.add_parser(
        "serve-exported",
        help="answer a test split from an export-serving blob alone (no "
             "checkpoint, no model build) and write the BOP CSV")
    p.add_argument("--cfg", required=True, help="reference-format config")
    p.add_argument("--obj_name", required=True)
    p_fleet = sub.add_parser(
        "serve-exported-fleet",
        help="answer K objects' test splits from one fleet serving blob; "
             "per-object BOP CSVs + one merged submission CSV")
    p_fleet.add_argument("--cfg", required=True)
    p_fleet.add_argument("--obj_names", required=True, nargs="+")
    for q in (p, p_fleet):
        q.add_argument("--blob", required=True,
                       help="export-serving artifact path")
        q.add_argument("--output_dir", default="eval_out")
        q.add_argument("--seed", type=int, default=0)
        q.add_argument("--max_samples", type=int, default=None)
        q.add_argument("--batch_size", type=int, default=16,
                       help="batch for symbolic-batch blobs (fixed-batch "
                            "blobs dictate their own)")
        q.add_argument("--vivo", action="store_true",
                       help="multi-instance walk (test_vivo semantics: "
                            "GT-less image walk, all detected instances, "
                            "score-carrying CSV)")
        q.add_argument("--score_threshold", type=float, default=0.2,
                       help="--vivo detection score threshold")
        _add_device(q)


def _export_serving(args, cfg, device) -> int:
    import torch

    from zebrapose_tpu_torch.codec.lut import load_correspondence_lut
    from zebrapose_tpu_torch.data.dataset_info import lookup_obj_id
    from zebrapose_tpu_torch.eval import export_serving as es
    from zebrapose_tpu_torch.eval.runner import (
        load_model,
        prepare_object_eval,
    )
    from zebrapose_tpu_torch.ops.pnp import PnPConfig

    for flag in ("platforms", "pallas"):
        if getattr(args, flag) is not None:
            raise SystemExit(
                f"--{flag}: a torch.export program runs on the device it "
                "was exported on, with that device's EPnP kernel; export "
                "on the serving device instead (--device)")
    fleet = args.command == "export-serving-fleet"
    names = args.obj_names if fleet else [args.obj_name]
    luts = [load_correspondence_lut(os.path.join(
        cfg.bop_path, cfg.dataset_name, "models_GT_color",
        f"Class_CorresPoint{lookup_obj_id(cfg.dataset_name, n):06d}.txt"))
        for n in names]
    kw = dict(crop_img=cfg.BoundingBox_CropSize_image,
              crop_gt=cfg.BoundingBox_CropSize_GT,
              base=cfg.divide_number_each_itration,
              n_bits=cfg.number_of_itration,
              resize_method=cfg.resize_method,
              loss_type=cfg.BinaryCode_Loss_Type,
              pnp_cfg=PnPConfig(n_hypotheses=args.n_hypotheses,
                                max_points=args.max_points),
              device=device)
    if fleet:
        from zebrapose_tpu_torch.eval.fleet_serve import _fleet_model
        if len(args.ckpt_files) != len(names):
            raise SystemExit("need one checkpoint per object")
        model, variables = _fleet_model(cfg, args.variant, args.ckpt_files,
                                        device, quant=args.int8)
        module = es.build_fleet_serving_fn(model, variables, luts,
                                           bf16=not args.f32, **kw)
    else:
        model = load_model(cfg, args.ckpt_file, args.variant, device=device,
                           quant=args.int8)
        if not args.f32:
            model = model.to(torch.bfloat16)
        module = es.build_serving_fn(model, luts[0],
                                     ignore_bits=args.ignore_bit, **kw)
    image_hw = (args.image_h, args.image_w)
    if args.roi_slice:
        naturals = [prepare_object_eval(cfg, n, roi_slice=True)
                    .dataset.natural_slice_hw() for n in names]
        image_hw = (max(h for h, _ in naturals),
                    max(w for _, w in naturals))
        print(f"roi_slice buffer from the walk: {image_hw}")
    meta = {"dataset": cfg.dataset_name, "roi_slice": args.roi_slice,
            "f32": args.f32, "int8": args.int8}
    meta.update({"obj_names": names} if fleet else {"obj_name": names[0]})
    t0 = time.perf_counter()
    blob = es.export_serving(module, args.batch or None, image_hw, meta=meta)
    export_s = time.perf_counter() - t0
    with open(args.out, "wb") as f:
        f.write(blob)
    print(json.dumps({
        "out": args.out, "bytes": len(blob), "n_models": len(names),
        "batch": args.batch or "symbolic", "image_hw": list(image_hw),
        "roi_slice": args.roi_slice, "int8": args.int8,
        "device": str(device),
        "export_s": export_s}))
    return 0


def _serve_exported(args, cfg, device) -> int:
    from zebrapose_tpu_torch.eval import export_serving as es

    common = dict(seed=args.seed, batch_size=args.batch_size, device=device)
    vivo = dict(score_threshold=args.score_threshold)
    test = dict(max_samples=args.max_samples)
    if args.command == "serve-exported":
        fn = (es.run_serve_exported_vivo if args.vivo
              else es.run_serve_exported)
        res = fn(cfg, args.obj_name, args.blob, args.output_dir,
                 **common, **(vivo if args.vivo else test))
    else:
        fn = (es.run_serve_exported_vivo_fleet if args.vivo
              else es.run_serve_exported_fleet)
        res = fn(cfg, args.obj_names, args.blob, args.output_dir,
                 **common, **(vivo if args.vivo else test))
    print(json.dumps(res))
    return 0


def _add_tools(sub):
    p = sub.add_parser(
        "visualize",
        help="full debug-artifact dump for one frame: mask panels, per-bit "
             "code-error grids, pose overlay (the reference's "
             "test_for_one_image.py / test_vis_mask.py, around the test "
             "--debug artifact set)")
    p.add_argument("--cfg", required=True, help="reference-format config")
    p.add_argument("--obj_name", required=True)
    p.add_argument("--ckpt_file", required=True,
                   help="compact .npz or reference-format .pth")
    p.add_argument("--scene", type=int, required=True,
                   help="BOP scene id (e.g. 2 for lmo test/000002)")
    p.add_argument("--im", type=int, required=True,
                   help="image id within the scene")
    p.add_argument("--output_dir", default="eval_out")
    p.add_argument("--variant", default="v2", choices=["v1", "v2", "v3"])
    p.add_argument("--ignore_bit", type=int, default=0)
    p.add_argument("--mask_rcnn", action="store_true")
    _add_device(p)

    p = sub.add_parser(
        "export-ckpt",
        help="export a checkpoint (.npz or .pth) to the reference's torch "
             ".pth format (utils_v2.save_checkpoint dict) so models trained "
             "here load in the reference's tooling")
    p.add_argument("--ckpt_file", required=True,
                   help="compact .npz or an existing .pth (orbax "
                        "directories: the JAX package's export-ckpt)")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--variant", default="v2", choices=["v1", "v2", "v3"])
    p.add_argument("--resnet_layers", type=int, default=34,
                   choices=[34, 50])
    p.add_argument("--code_length", type=int, default=16)
    p.add_argument("--crop", type=int, default=256,
                   help="the JAX package's orbax init size; a .npz or "
                        ".pth needs none")
    p.add_argument("--step", type=int, default=0)
    p.add_argument("--best_score", type=float, default=0.0)
    p.add_argument("--base", type=int, default=2,
                   help="divide_number_each_itration; != 2 selects the "
                        "non-binary head layout")
    _add_device(p)

    p = sub.add_parser(
        "model-cost",
        help="params and FLOPs of one eval forward (the reference's thop "
             "harness, model/BinaryCodeNet.py:199-205; FLOPs by "
             "torch.utils.flop_counter)")
    p.add_argument("--variant", default="v2", choices=["v1", "v2", "v3"])
    p.add_argument("--resnet_layers", type=int, default=34,
                   choices=[34, 50])
    p.add_argument("--code_length", type=int, default=16)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--no_concat", action="store_true")
    _add_device(p)


def _export_ckpt(args, device) -> int:
    from zebrapose_tpu_torch.eval.runner import load_model_variables
    from zebrapose_tpu_torch.models.convert import (
        save_reference_checkpoint,
        state_dict_to_variables,
    )
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet

    nonbinary = args.base != 2
    if args.ckpt_file.endswith(".npz"):
        from zebrapose_tpu_torch.utils.compact_ckpt import load_compact
        variables, _ = load_compact(args.ckpt_file)
    else:
        variables = state_dict_to_variables(
            load_model_variables(args.ckpt_file, args.variant,
                                 resnet_layers=args.resnet_layers,
                                 nonbinary=nonbinary),
            args.variant, nonbinary=nonbinary,
            resnet_layers=args.resnet_layers)
    save_reference_checkpoint(
        args.out, variables, iteration_step=args.step,
        best_score=args.best_score, variant=args.variant,
        nonbinary=nonbinary, resnet_layers=args.resnet_layers)
    # the written file strict-loads into the model it names, on --device
    model = ZebraPoseNet(binary_code_length=args.code_length, base=args.base,
                         variant=args.variant,
                         resnet_layers=args.resnet_layers).to(device)
    model.load_state_dict(load_model_variables(
        args.out, args.variant, resnet_layers=args.resnet_layers,
        nonbinary=nonbinary), strict=True)
    print(f"exported {args.ckpt_file} -> {args.out}")
    return 0


def _model_cost(args, device) -> int:
    import torch

    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
    from zebrapose_tpu_torch.utils.profiling import model_cost

    model = ZebraPoseNet(binary_code_length=args.code_length,
                         variant=args.variant,
                         resnet_layers=args.resnet_layers,
                         concat=not args.no_concat)
    model = model.to(device).to(memory_format=torch.channels_last)
    cost = model_cost(model, torch.zeros(
        (1, args.crop, args.crop, 3), device=device))
    print(json.dumps({"params_M": round(cost["params"] / 1e6, 3),
                      "flops_G": round(cost["flops"] / 1e9, 3)}))
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="zebrapose_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_train(sub)
    _add_fleet(sub)
    _add_serving(sub)
    _add_tools(sub)

    p_test = sub.add_parser("test", help="evaluate one object (test.py)")
    p_test.add_argument("--cfg", required=True, help="reference-format config")
    p_test.add_argument("--obj_name", required=True)
    p_test.add_argument("--ckpt_file", required=True,
                        help="compact .npz or reference-format .pth")
    p_test.add_argument("--output_dir", default="eval_out")
    p_test.add_argument("--ignore_bit", type=int, default=0)
    p_test.add_argument("--variant", default="v2",
                        choices=["v1", "v2", "v3"])
    p_test.add_argument("--debug", action="store_true",
                        help="write the reference's debug artifacts (mask "
                             "panels, code-error grids, pose outlines, the "
                             "refiner's frames) under <run dir>/debug")
    p_test.add_argument("--batch_size", type=int, default=16)
    p_test.add_argument("--max_samples", type=int, default=None)
    p_test.add_argument("--mask_rcnn", action="store_true",
                        help="use the detector's RLE segmentation instead "
                             "of the mask head (test_for_mask_rcnn.py)")
    p_test.add_argument("--int8", action="store_true", help=_INT8_HELP)
    p_test.add_argument("--roi_slice", action="store_true",
                        help="ship only each frame's clamped square-bbox "
                             "bytes to the device (bit-exact crops)")
    p_test.add_argument("--profile", default=None,
                        help="write a torch.profiler Chrome trace "
                             "(trace.json) to this dir")
    _add_pnp_flags(p_test)
    _add_device(p_test)

    p_vivo = sub.add_parser("vivo",
                            help="multi-instance eval (test_vivo)")
    p_vivo.add_argument("--cfg", required=True, help="reference-format config")
    p_vivo.add_argument("--obj_name", required=True)
    p_vivo.add_argument("--ckpt_file", required=True,
                        help="compact .npz or reference-format .pth")
    p_vivo.add_argument("--output_dir", default="eval_out")
    p_vivo.add_argument("--variant", default="v2")
    p_vivo.add_argument("--score_threshold", type=float, default=0.2)
    p_vivo.add_argument("--batch_size", type=int, default=16)
    p_vivo.add_argument("--int8", action="store_true", help=_INT8_HELP)
    p_vivo.add_argument("--mask_rcnn", action="store_true",
                        help="use detector RLE segmentations "
                             "(test_vivo_for_mask_rcnn.py)")
    p_vivo.add_argument("--roi_slice", action="store_true",
                        help="ship only each frame's clamped square-bbox "
                             "bytes to the device (bit-exact crops)")
    _add_pnp_flags(p_vivo)
    _add_device(p_vivo)

    p_score = sub.add_parser(
        "score-bop",
        help="BOP19 challenge scoring (AR_vsd/mssd/mspd) of a submission "
             "CSV against a BOP dataset tree")
    p_score.add_argument("--csv", required=True,
                         help="submission CSV (merge-csv output)")
    p_score.add_argument("--bop_path", required=True)
    p_score.add_argument("--dataset", required=True)
    p_score.add_argument("--split", default="test")
    p_score.add_argument("--no_vsd", action="store_true",
                         help="skip VSD even if depth images exist")
    _add_device(p_score)

    p_merge = sub.add_parser("merge-csv", help="merge per-object CSVs")
    p_merge.add_argument("csvs", nargs="+")
    p_merge.add_argument("--out", required=True)

    p_mesh = sub.add_parser("generate-mesh-code",
                            help="hierarchical surface encoding of a mesh")
    p_mesh.add_argument("--mesh", required=True)
    p_mesh.add_argument("-d", "--divide_number", type=int, default=2)
    p_mesh.add_argument("-n", "--levels", type=int, default=16)
    p_mesh.add_argument("--corres_txt", required=True)
    p_mesh.add_argument("--colored_ply", default=None)

    p_lab = sub.add_parser("generate-labels",
                           help="render GT_v2 label images for a split")
    p_lab.add_argument("--cfg", required=True, help="reference-format config")
    p_lab.add_argument("--obj_name", required=True)
    p_lab.add_argument("--data_folder", default=None,
                       help="defaults to cfg.training_data_folder")
    p_lab.add_argument("--force", action="store_true")

    args = parser.parse_args(argv)

    if args.command == "train":
        return _train(args)
    if args.command == "train-fleet":
        return _train_fleet(args)
    if args.command == "merge-csv":
        from zebrapose_tpu_torch.data.bop_writer import merge_csv
        merge_csv(args.csvs, args.out)
        print(f"merged {len(args.csvs)} files -> {args.out}")
        return 0
    if args.command == "generate-mesh-code":
        from zebrapose_tpu_torch.tools.generate_gt import (
            generate_mesh_surface_code,
        )
        lut, _ = generate_mesh_surface_code(
            args.mesh, args.divide_number, args.levels, args.corres_txt,
            args.colored_ply)
        print(f"{lut.num_classes} classes, "
              f"{int(lut.valid.sum())} non-empty -> {args.corres_txt}")
        return 0
    if args.command == "generate-labels":
        from zebrapose_tpu_torch.config import ZebraConfig
        from zebrapose_tpu_torch.tools.label_driver import generate_labels_cli
        cfg = ZebraConfig.from_file(args.cfg)
        n = generate_labels_cli(
            cfg, args.obj_name,
            data_folder=args.data_folder or cfg.training_data_folder,
            force=args.force)
        print(f"wrote {n} label images")
        return 0

    from zebrapose_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.command in ("test-fleet", "vivo-fleet"):
        return _eval_fleet(args, device)
    if args.command in ("export-serving", "export-serving-fleet"):
        from zebrapose_tpu_torch.config import ZebraConfig
        return _export_serving(args, ZebraConfig.from_file(args.cfg), device)
    if args.command in ("serve-exported", "serve-exported-fleet"):
        from zebrapose_tpu_torch.config import ZebraConfig
        return _serve_exported(args, ZebraConfig.from_file(args.cfg), device)
    if args.command == "model-cost":
        return _model_cost(args, device)
    if args.command == "export-ckpt":
        return _export_ckpt(args, device)
    if args.command == "score-bop":
        from zebrapose_tpu_torch.eval.bop_score import score_csv
        res = score_csv(args.csv, args.bop_path, args.dataset,
                        split=args.split,
                        with_vsd=False if args.no_vsd else None,
                        device=device)
        print(json.dumps(res, indent=2))
        return 0

    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.utils.logging import TeeOutput, prepare_eval_dir

    cfg = ZebraConfig.from_file(args.cfg)
    # Reference test.py:589-602: each eval run gets a timestamped dir
    # with the effective config in config.txt and the console in log.txt.
    items = dict(cfg.to_dict())
    items.update({"obj_name": args.obj_name,
                  "checkpoint_file": args.ckpt_file,
                  "command": args.command, "device": str(device)})
    if args.command == "test":
        items["ignore_bit"] = args.ignore_bit
    if args.command == "visualize":
        items["frame"] = f"{args.scene}/{args.im}"
    run_dir = prepare_eval_dir(args.output_dir, items)
    with TeeOutput(os.path.join(run_dir, "log.txt")):
        print(f"eval run dir: {run_dir}")
        if args.command == "visualize":
            from zebrapose_tpu_torch.eval.runner import run_test
            metrics = run_test(
                cfg, args.obj_name, args.ckpt_file, run_dir,
                ignore_bit=args.ignore_bit, variant=args.variant,
                debug=True, batch_size=1, mask_rcnn=args.mask_rcnn,
                frame=(args.scene, args.im), device=device)
            print(json.dumps(metrics, indent=2))
            print(f"debug artifacts: {os.path.join(run_dir, 'debug')}")
            return 0
        if args.command == "test":
            from zebrapose_tpu_torch.eval.runner import run_test
            from zebrapose_tpu_torch.utils.profiling import profile_trace
            with profile_trace(args.profile):
                metrics = run_test(
                    cfg, args.obj_name, args.ckpt_file, run_dir,
                    ignore_bit=args.ignore_bit, variant=args.variant,
                    debug=args.debug, batch_size=args.batch_size,
                    max_samples=args.max_samples, mask_rcnn=args.mask_rcnn,
                    int8=args.int8, roi_slice=args.roi_slice,
                    pnp_cfg=_pnp_cfg_from_args(args), device=device)
        else:
            from zebrapose_tpu_torch.eval.runner_vivo import run_vivo
            metrics = run_vivo(
                cfg, args.obj_name, args.ckpt_file, run_dir,
                variant=args.variant, score_threshold=args.score_threshold,
                batch_size=args.batch_size, mask_rcnn=args.mask_rcnn,
                int8=args.int8, roi_slice=args.roi_slice,
                pnp_cfg=_pnp_cfg_from_args(args), device=device)
        print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
