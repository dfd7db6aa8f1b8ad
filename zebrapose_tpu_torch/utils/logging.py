"""Evaluation run directories and console capture.

The port's copy of `prepare_eval_dir` and `TeeOutput` from
`zebrapose_tpu/utils/logging.py` (the metrics logger belongs to the
training slice).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict


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
