"""The benchmark of `zebrapose_tpu_torch` on NVIDIA H100 cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell names a configuration and a
traffic mix in `BENCHMARK.json`; the traffic names its driver. With
--trace 0 the last line of standard output holds the cell's end-to-end
metrics, with --trace 1 its per-layer metrics (each read by its own
file under `metrics/`) and the device's busy time. Either way the run
checks what its timed path produced against the plain reference under
`reference/` and prints each compared number beside its limit. Exits
non-zero, with no result, without the cards the cell asks for, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    start = harness.process_start_epoch()
    os.environ.update(harness.library_environment())
    try:
        cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                            args.workload)
    except harness.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; this benchmark measures the "
              "card and does not fall back to the CPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    try:
        import zebrapose_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"benchmark: the port is not in this checkout: {e}",
              file=sys.stderr)
        return 4

    result, checks = cell.driver().run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), process_start=start)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 5
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
