"""Checkpoints: rolling keep-3 by step plus one best-by-score.

Port of `zebrapose_tpu/train/checkpoints.py` on `torch.save` (the JAX
package uses orbax). The policy is the reference's
(`zebrapose/utils_v2.py:4-51`): numeric-step checkpoints with the newest
`keep` kept, and a single best checkpoint whose score is also written
to `best/best_score.txt`.

A payload is the reference's `.pth` layout (`model_state_dict`,
`iteration_step`, `best_score`, as
`zebrapose_tpu/models/convert_torch.py::save_reference_checkpoint`
writes it), so `python -m zebrapose_tpu_torch test --ckpt_file` loads
one as it is, plus `optimizer_state_dict`, `histogram` and `step` for an
exact resume. Files: `<dir>/steps/step_<N>.pth`,
`<dir>/best/step_<N>.pth`.

`save` copies the state to host memory in the caller's thread and
writes the file on a background thread, so the write overlaps the next
steps; `wait` (and every reader) waits for the writes in flight.

In a data-parallel world only rank 0 writes (`write=False` on the
others: `save` and `save_best` do nothing there), and every rank
restores the same file (`parallel.mesh.replicate` then checks that the
ranks stand at one step).
"""

from __future__ import annotations

import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from zebrapose_tpu_torch.train.state import TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pth$")


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_payload(state: TrainState,
                  best_score: Optional[float] = None) -> Dict:
    """The state as a host-memory checkpoint dict."""
    return {
        "model_state_dict": _to_host(state.model.state_dict()),
        "iteration_step": int(state.step),
        "best_score": float(state.best_score if best_score is None
                            else best_score),
        "optimizer_state_dict": _to_host(state.optimizer.state_dict()),
        "histogram": _to_host(state.histogram),
        "step": int(state.step),
    }


def load_payload(state: TrainState, payload: Dict) -> TrainState:
    """Restore a checkpoint dict into `state` (strict), in place."""
    dev = state.histogram.device
    state.model.load_state_dict(payload["model_state_dict"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer_state_dict"])
    state.histogram = payload["histogram"].to(dev)
    state.step = int(payload["step"])
    state.best_score = float(payload["best_score"])
    return state


def _steps_in(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(directory)) if m)


def _write(payload: Dict, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Rolling step checkpoints (keep `keep`) + one best checkpoint."""

    def __init__(self, directory: str, keep: int = 3, write: bool = True):
        self.directory = os.path.abspath(directory)
        self.steps_dir = os.path.join(self.directory, "steps")
        self.best_dir = os.path.join(self.directory, "best")
        self.write = write
        if write:
            os.makedirs(self.steps_dir, exist_ok=True)
        self.keep = keep
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Future] = []

    def path(self, step: int) -> str:
        return os.path.join(self.steps_dir, f"step_{step}.pth")

    # -- rolling ----------------------------------------------------------
    def save(self, state: TrainState) -> None:
        """Copy the state to the host now; write it and drop the oldest
        files beyond `keep` on the writer thread."""
        if not self.write:
            return
        payload = state_payload(state)
        path = self.path(int(state.step))

        def write():
            _write(payload, path)
            for old in _steps_in(self.steps_dir)[:-self.keep]:
                os.remove(self.path(old))

        self._pending.append(self._writer.submit(write))

    def wait(self) -> None:
        """Block until the writes in flight are on disk; re-raises a
        failed write."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = _steps_in(self.steps_dir)
        return steps[-1] if steps else None

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load the latest (or `step`'s) rolling checkpoint into `state`;
        without one, `state` is returned as it is."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state
        return load_payload(state, torch.load(
            self.path(step), map_location="cpu", weights_only=True))

    # -- best -------------------------------------------------------------
    def best_path(self) -> Optional[str]:
        steps = _steps_in(self.best_dir)
        return (os.path.join(self.best_dir, f"step_{steps[-1]}.pth")
                if steps else None)

    def save_best(self, state: TrainState, score: float) -> None:
        """Replace the best checkpoint with `state` (written now)."""
        if not self.write:
            return
        self.wait()
        if os.path.isdir(self.best_dir):
            shutil.rmtree(self.best_dir)
        os.makedirs(self.best_dir)
        step = int(state.step)
        _write(state_payload(state, score),
               os.path.join(self.best_dir, f"step_{step}.pth"))
        with open(os.path.join(self.best_dir, "best_score.txt"), "w") as f:
            f.write(f"{score} step {step}\n")

    def restore_best(self, state: TrainState) -> Optional[TrainState]:
        path = self.best_path()
        if path is None:
            return None
        return load_payload(state, torch.load(path, map_location="cpu",
                                              weights_only=True))

    def close(self) -> None:
        self.wait()
        self._writer.shutdown(wait=True)
