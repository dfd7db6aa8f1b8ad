"""Command line of the port: the reference's test.py entry point.

  python -m zebrapose_tpu_torch test --cfg cfg.txt --obj_name ape \
      --ckpt_file <.npz or .pth> [--batch_size N] [--escalate_h 256] \
      [--device cuda|cpu]
  python -m zebrapose_tpu_torch merge-csv a.csv b.csv --out all.csv

The flags are those of `python -m zebrapose_tpu test` plus `--device`
(default cuda; without CUDA the command fails unless `--device cpu` is
given). The config file is the reference's flat `key = value` format.
The other commands of the JAX package's CLI are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _pnp_cfg_from_args(args):
    from zebrapose_tpu_torch.ops.pnp import PnPConfig
    kw = {}
    if args.escalate_h:
        kw["escalate_hypotheses"] = args.escalate_h
        kw["escalate_inlier_frac"] = args.escalate_frac
    return PnPConfig(**kw)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="zebrapose_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

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
    p_test.add_argument("--escalate_h", type=int, default=0,
                        help="adaptive RANSAC second stage: redraw with "
                             "this many hypotheses when a frame's inlier "
                             "fraction is weak (0 = off)")
    p_test.add_argument("--escalate_frac", type=float, default=0.4,
                        help="inlier fraction below which the second "
                             "RANSAC stage triggers")
    p_test.add_argument("--device", default="cuda",
                        help="torch device (cuda, cuda:N or cpu)")

    p_merge = sub.add_parser("merge-csv", help="merge per-object CSVs")
    p_merge.add_argument("csvs", nargs="+")
    p_merge.add_argument("--out", required=True)

    args = parser.parse_args(argv)

    if args.command == "merge-csv":
        from zebrapose_tpu_torch.data.bop_writer import merge_csv
        merge_csv(args.csvs, args.out)
        print(f"merged {len(args.csvs)} files -> {args.out}")
        return 0

    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.eval.runner import run_test
    from zebrapose_tpu_torch.utils.device import resolve_device
    from zebrapose_tpu_torch.utils.logging import TeeOutput, prepare_eval_dir
    from zebrapose_tpu_torch.utils.profiling import profile_trace

    device = resolve_device(args.device)
    cfg = ZebraConfig.from_file(args.cfg)
    # Reference test.py:589-602: each eval run gets a timestamped dir
    # with the effective config in config.txt and the console in log.txt.
    items = dict(cfg.to_dict())
    items.update({"obj_name": args.obj_name,
                  "checkpoint_file": args.ckpt_file,
                  "command": args.command, "ignore_bit": args.ignore_bit,
                  "device": str(device)})
    run_dir = prepare_eval_dir(args.output_dir, items)
    with TeeOutput(os.path.join(run_dir, "log.txt")):
        print(f"eval run dir: {run_dir}")
        with profile_trace(args.profile):
            metrics = run_test(
                cfg, args.obj_name, args.ckpt_file, run_dir,
                ignore_bit=args.ignore_bit, variant=args.variant,
                debug=args.debug, batch_size=args.batch_size,
                max_samples=args.max_samples, mask_rcnn=args.mask_rcnn,
                int8=args.int8, roi_slice=args.roi_slice,
                pnp_cfg=_pnp_cfg_from_args(args), device=device)
        print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
