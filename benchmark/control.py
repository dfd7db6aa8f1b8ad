"""Readings that the limits of a cell's compared numbers are set from:
the program's (sound runs, the lower readings) and the control's (the
upper readings), on many seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 3] [--out readings.jsonl]

For each seed, one batch of the cell's traffic goes through the timed
path as a run drives it (the same step, batch, sizes and capture), and
`checks.serve_numbers` compares it with the reference; on the first
`--control-seeds` seeds the control takes the program's place: the
crop in bfloat16; the forward of the nearest lower precision (a bf16
configuration: the program's own int8 path; an int8 configuration: the
reference's arithmetic with int4 codes, qmax 7); the hypotheses,
scoring, refit and polish with TF32. A training cell's control is the
reference's steps on fp8 operands, beside the fault of half the batch.
Prints one JSON line per reading, with whether the cell's limits passed
it.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_forward(cfg: dict, device):
    """The control's forward: (fn(crop) -> logits)."""
    import torch

    from benchmark.drivers import serve as drv
    from benchmark.reference.layers import TorchConv

    if not cfg.get("int8", False):
        model = drv.build_model(cfg, device, quant=True)
        dtype = getattr(torch, cfg["serve_dtype"])
        return lambda crop: model(crop.to(dtype))
    ref = drv.reference_side(cfg, device).model
    for m in ref.modules():
        if isinstance(m, TorchConv):
            m.qmax = 7
    return lambda crop: ref(crop.float())


def train_readings(cell, seeds, control_seeds: int, device):
    """(seed, 0, kind, numbers): the program's first steps on each seed,
    and on the first `control_seeds` seeds the control (the reference's
    steps with every conv on fp8 operands, `reference/fp8.py`, in the
    program's place) and the fault of half the batch left out."""
    import torch

    from benchmark import checks
    from benchmark.drivers import train as drv

    cfg, tr = cell.config, cell.traffic
    n = int(tr["checked_steps"])
    for i, seed in enumerate(seeds):
        split = drv.Split(cfg, tr, seed, device)
        faults = [None] + (["half"] if i < control_seeds else [])
        for fault in faults:
            trainer = drv.Trainer(cfg, tr, seed, device, split)
            snap = trainer.checked_steps(n, fault)
            init = trainer.init
            del trainer
            yield seed, 0, "fault_" + fault if fault else "program", \
                checks.train_numbers(cfg, tr, seed, split, init, snap, device)
            if fault is None and i < control_seeds:
                ctl = checks.reference_steps(cfg, tr, seed, split, init, n,
                                             device, fp8=True)
                yield seed, 0, "control", checks.train_numbers(
                    cfg, tr, seed, split, init, ctl, device)
                del ctl
            if device.type == "cuda":
                torch.cuda.empty_cache()
        del split


def readings(cell, seeds, control_seeds: int, device):
    """(seed, batch, "program" | "control", numbers) for each seed."""
    if cell.traffic["driver"] == "train":
        yield from train_readings(cell, seeds, control_seeds, device)
        return
    import torch

    from benchmark import checks
    from benchmark.drivers import serve as drv

    cfg, tr = cell.config, cell.traffic
    server = drv.Server(cfg, device)
    ref = drv.reference_side(cfg, device)
    ctl_fwd = control_forward(cfg, device)
    warm = int(tr["warmup_batches"])
    for i, seed in enumerate(seeds):
        traffic = drv.Traffic(cfg, tr, seed, device)
        k = min(drv.captured_batches(tr, seed, warm))
        _, caps, _ = drv.serve(server, traffic, 0, lambda kk, t: kk > k,
                               captures={k}, int8_rows=True)
        cap = caps[0]
        yield seed, k, "program", checks.serve_numbers(ref, cap)
        if i < control_seeds:
            with torch.no_grad():
                control = {"crop": ref.crop(cap).to(torch.bfloat16).float(),
                           "logits": ctl_fwd(cap["crop"]), "tf32": True,
                           "hyp_dtype": torch.bfloat16}
            yield seed, k, "control", checks.serve_numbers(
                ref, cap, control=control)
        del caps, cap
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import checks, harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        limits = cell.config["limits"][
            "train" if cell.traffic["driver"] == "train" else "serve"]
        for seed, k, kind, nums in readings(
                cell, args.seeds, args.control_seeds,
                torch.device("cuda", 0)):
            passed = checks.passed(checks.judge(nums, limits))
            line = json.dumps({"workload": cell.name, "seed": seed,
                               "batch": k, "kind": kind, "passed": passed,
                               **nums})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
