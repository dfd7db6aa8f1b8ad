"""Command line of the port: the reference's train, test and BOP commands.

  python -m zebrapose_tpu_torch train --cfg cfg.txt --obj_name ape \
      [--from_scratch | --pretrained_backbone resnet34.pth] [--bf16] \
      [--max_steps N] [--log_freq N] [--cache_images] [--device cuda|cpu]
  python -m zebrapose_tpu_torch test --cfg cfg.txt --obj_name ape \
      --ckpt_file <.npz or .pth> [--batch_size N] [--escalate_h 256] \
      [--device cuda|cpu]
  python -m zebrapose_tpu_torch vivo --cfg cfg.txt --obj_name ape \
      --ckpt_file <.npz or .pth> [--score_threshold 0.2] [--batch_size N] \
      [--mask_rcnn] [--roi_slice] [--escalate_h 256] [--device cuda|cpu]
  python -m zebrapose_tpu_torch score-bop --csv sub.csv --bop_path DIR \
      --dataset lmo [--split test] [--no_vsd] [--device cuda|cpu]
  python -m zebrapose_tpu_torch merge-csv a.csv b.csv --out all.csv
  python -m zebrapose_tpu_torch generate-mesh-code --mesh obj.ply -d 2 \
      -n 16 --corres_txt Class_CorresPoint000001.txt [--colored_ply c.ply]
  python -m zebrapose_tpu_torch generate-labels --cfg cfg.txt \
      --obj_name ape [--data_folder train_pbr] [--force]

The flags are those of `python -m zebrapose_tpu train` / `test` /
`vivo` / `score-bop` plus `--device` (default cuda; without CUDA a
command fails unless `--device cpu` is given). `train` writes
`<output_dir>/<dataset>_<obj>/checkpoints/` (reference-format .pth files
that `test` loads) and `logs/metrics.jsonl`. Its `--qat`, `--multihost`
and `--input_mode prefetch | device_cache` raise NotImplementedError, as
`--int8` does for `test` and `vivo`. `vivo` (the BOP-challenge
multi-instance protocol over detections) writes the submission CSV that
`score-bop` scores (BOP19 AR_vsd / AR_mssd / AR_mspd; the result is
printed as JSON). The config file is the reference's flat `key = value`
format. `generate-mesh-code` (a mesh's hierarchical surface code:
`Class_CorresPoint*.txt` and the colored mesh) and `generate-labels` (the
`<split>_GT_v2` label images of one object over a BOP split, writing the
surface code first when it is absent) are host work in both stacks:
numpy and the port's C++ library (`native/`). They take no `--device` and
touch no tensor on any device; the JAX package's commands never reach an
accelerator either, so this is not a CPU fallback. The other commands of
the JAX package's CLI (among them `vivo-fleet` and `serve-exported
--vivo`) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


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


_UNPORTED = "is not ported yet (see ROADMAP.md, queue A)"


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
                   help="quantization-aware training (not ported yet)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host training (not ported yet)")
    p.add_argument("--input_mode", default="stream",
                   choices=["stream", "prefetch", "device_cache"],
                   help="stream = host MixedBatchIterator; prefetch and "
                        "device_cache are not ported yet")
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


def _train(args) -> int:
    if args.qat:
        raise NotImplementedError("--qat " + _UNPORTED)
    if args.multihost:
        raise NotImplementedError("--multihost " + _UNPORTED)
    if args.input_mode != "stream":
        raise NotImplementedError(f"--input_mode {args.input_mode} "
                                  + _UNPORTED)
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.train.trainer import build_train_setup, fit
    from zebrapose_tpu_torch.utils.device import resolve_device
    from zebrapose_tpu_torch.utils.profiling import profile_trace

    device = resolve_device(args.device)
    cfg = ZebraConfig.from_file(args.cfg)
    out = os.path.join(args.output_dir, f"{cfg.dataset_name}_{args.obj_name}")
    res = build_train_setup(
        cfg, args.obj_name, out, variant=args.variant,
        pretrained_backbone=(None if args.from_scratch
                             else args.pretrained_backbone),
        bf16=args.bf16, gamma=args.gamma, log_freq=args.log_freq,
        cache_images=args.cache_images, accum_steps=args.accum_steps,
        gt_dir_suffix="_GT" if args.gt_labels == "v1" else "_GT_v2",
        device=device)
    timing = {}
    try:
        with profile_trace(args.profile):
            best = fit(res, log_freq=args.log_freq, max_steps=args.max_steps,
                       val_mode=args.val_mode, timing=timing)
        # where this run's time went, in seconds (fit's stages)
        res.logger.log(res.state.step, timing, prefix="timing/")
    finally:
        res.ckpt.close()
        res.logger.close()
    print(f"best val recall: {best}")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="zebrapose_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_train(sub)

    p_test = sub.add_parser("test", help="evaluate one object (test.py)")
    p_test.add_argument("--cfg", required=True, help="reference-format config")
    p_test.add_argument("--obj_name", required=True)
    p_test.add_argument("--ckpt_file", required=True,
                        help="compact .npz or reference-format .pth")
    p_test.add_argument("--output_dir", default="eval_out")
    p_test.add_argument("--ignore_bit", type=int, default=0)
    p_test.add_argument("--variant", default="v2",
                        choices=["v1", "v2", "v3"])
    p_test.add_argument("--debug", action="store_true")
    p_test.add_argument("--batch_size", type=int, default=16)
    p_test.add_argument("--max_samples", type=int, default=None)
    p_test.add_argument("--mask_rcnn", action="store_true",
                        help="use the detector's RLE segmentation instead "
                             "of the mask head (test_for_mask_rcnn.py)")
    p_test.add_argument("--int8", action="store_true",
                        help="int8 conv compute (not ported yet)")
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
    p_vivo.add_argument("--int8", action="store_true",
                        help="int8 conv compute (not ported yet)")
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
    run_dir = prepare_eval_dir(args.output_dir, items)
    with TeeOutput(os.path.join(run_dir, "log.txt")):
        print(f"eval run dir: {run_dir}")
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
