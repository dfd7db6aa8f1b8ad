"""Metrics logging, evaluation run directories and console capture.

The port's copy of `MetricsLogger`, `prepare_eval_dir` and `TeeOutput`
from `zebrapose_tpu/utils/logging.py`.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Sequence


class MetricsLogger:
    """Scalars to `<log_dir>/metrics.jsonl` (one {"step", "tag",
    "value", "ts"} row per scalar) and to stdout; also to TensorBoard
    when tensorboardX imports. The reference prints and writes
    TensorBoard scalars (train_v2.py:271-336)."""

    def __init__(self, log_dir: str, also_stdout: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.also_stdout = also_stdout
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # optional
            self._tb = SummaryWriter(log_dir)
        except ImportError:
            pass

    def _row(self, step: int, tag: str, value: float, now: float) -> None:
        self._f.write(json.dumps({"step": int(step), "tag": tag,
                                  "value": float(value), "ts": now}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = "") -> None:
        now = time.time()
        for tag, value in scalars.items():
            self._row(step, f"{prefix}{tag}", value, now)
        self._f.flush()
        if self.also_stdout:
            msg = " ".join(f"{k}={float(v):.5g}" for k, v in scalars.items())
            print(f"[step {step}] {prefix}{msg}", flush=True)

    def log_series(self, tag: str, steps: Sequence[int],
                   values: Sequence[float]) -> None:
        """One row per step for `tag`, file only (the per-step losses
        the reference prints, written once per log cadence)."""
        now = time.time()
        for s, v in zip(steps, values):
            self._row(s, tag, v, now)
        self._f.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """MetricsLogger's interface writing nothing: the logger of every
    rank but rank 0 in a data-parallel world."""

    def log(self, step, scalars, prefix: str = "") -> None:
        pass

    def log_series(self, tag, steps, values) -> None:
        pass

    def close(self) -> None:
        pass


def prepare_eval_dir(output_dir: str, config_items: Dict,
                     timestamp: bool = True) -> str:
    """Timestamped eval run dir + full config dump, the reference's
    test.py:589-598 semantics: artifacts of each run land in
    `<output_dir>/<YYYY-mm-dd-HH-MM-SS>/` with a `config.txt` listing
    every config key (incl. CLI overlays) between start/end markers.
    """
    run_dir = (os.path.join(output_dir, time.strftime("%Y-%m-%d-%H-%M-%S"))
               if timestamp else output_dir)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.txt"), "w") as f:
        f.write("------------------ start ------------------\n")
        for k, v in config_items.items():
            f.write(f"{k} : {v}\n")
        f.write("------------------- end -------------------")
    return run_dir


class _Tee:
    def __init__(self, console, f):
        self._a, self._b = console, f

    def write(self, s):
        self._a.write(s)
        if not self._b.closed:
            self._b.write(s)
        return len(s)

    def flush(self):
        self._a.flush()
        if not self._b.closed:
            self._b.flush()

    def close(self):
        # a library that captured this stream may close it at exit;
        # never close the real console, just flush
        self.flush()

    def isatty(self):
        return False

    def fileno(self):
        return self._a.fileno()


class TeeOutput:
    """Duplicate stdout+stderr into `log_path` for the duration of a
    `with` block (the reference redirects both wholesale, test.py:600-602;
    tee-ing keeps the console). The file opens in append mode so writes
    interleave with run_test's own metric appends."""

    def __init__(self, log_path: str):
        self.log_path = log_path

    def __enter__(self):
        self._stdout, self._stderr = sys.stdout, sys.stderr
        self._f = open(self.log_path, "a")
        sys.stdout = _Tee(self._stdout, self._f)
        sys.stderr = _Tee(self._stderr, self._f)
        return self

    def __exit__(self, *exc):
        sys.stdout, sys.stderr = self._stdout, self._stderr
        self._f.close()
        return False
