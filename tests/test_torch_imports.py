"""Import hygiene of the PyTorch port.

The port and `chip_smoke.py` must run where JAX, cv2 and PIL are not
installed: they import neither `jax`, `flax`, `optax`, `orbax`,
`ml_dtypes`, `cv2`, `PIL` nor any `zebrapose_tpu` module. The check
runs in a subprocess, because this test process already imported JAX
(tests/conftest.py), with those modules blocked (an import of one
fails, as on the card's machine). Also: entry points refuse to fall back to the CPU,
and importing the port leaves the TF32 switches at PyTorch's defaults.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "zebrapose_tpu_torch")

_PROBE = r"""
import importlib, importlib.abc, json, pkgutil, sys
roots = ("jax", "flax", "optax", "orbax", "ml_dtypes", "cv2", "PIL",
         "zebrapose_tpu")


class Blocked(importlib.abc.MetaPathFinder):
    # the card's machine has none of these: importing one fails there
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in roots:
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, Blocked())
import torch
import zebrapose_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(zebrapose_tpu_torch.__path__,
                                              "zebrapose_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401  (its import closure; main() does not run)
bad = sorted(m for m in sys.modules
             if m in roots or m.startswith(tuple(r + "." for r in roots)))
print(json.dumps({"modules": mods, "bad": bad,
                  "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                  "cudnn_tf32": torch.backends.cudnn.allow_tf32}))
"""


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp"))]
    return files


def test_port_imports_no_jax_in_subprocess():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    expected = {"codec.surface_code", "codec.lut", "utils.compact_ckpt",
                "ops.roi", "data.pipeline", "models.layers",
                "models.resnet", "models.aspp", "models.zebra_net",
                "models.convert", "ops.binarize", "ops.fast_linalg",
                "ops.pnp_kernel", "ops.pnp", "ops.metrics",
                "eval.evaluate", "data.png", "config", "data.dataset_info",
                "data.bop_io", "data.detections", "data.bop_writer",
                "utils.logging", "utils.profiling", "eval.runner", "cli",
                "__main__", "models.losses", "ops.augment", "train.state",
                "train.train_step", "train.checkpoints", "train.trainer",
                "parallel.mesh", "native", "ops.bop_errors",
                "eval.bop_score", "eval.vivo", "eval.runner_vivo",
                "data.jpeg", "data.tiff", "tools.symmetry",
                "tools.generate_gt", "tools.label_driver", "train.fleet",
                "eval.fleet_serve", "eval.export_serving",
                "utils.visualize", "tools.fibonacci_code"}
    assert {"zebrapose_tpu_torch." + m for m in expected} <= \
        set(res["modules"])
    # the port does not touch the TF32 switches: float32 matmuls stay
    # full precision (PyTorch's default), cuDNN keeps its default
    assert res["matmul_tf32"] is False
    assert res["cudnn_tf32"] is True


def test_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from) "
                     r"(jax|flax|optax|orbax|ml_dtypes|cv2|PIL)\b"
                     r"|zebrapose_tpu\.", re.M)
    hits = []
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        hits += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                 for m in pat.finditer(text)]
    assert hits == []


def test_entry_points_raise_without_cuda(monkeypatch):
    from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
    from zebrapose_tpu_torch.eval.evaluate import make_eval_step
    from zebrapose_tpu_torch.ops.pnp import PnPConfig, decode_to_pose_batch
    from zebrapose_tpu_torch.ops.pnp_kernel import minimal_epnp_hypotheses

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lut = CorrespondenceLUT(np.zeros((4, 3), np.float32),
                            np.ones(4, bool), 2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(lambda b: b, lut, 64, 32, 2, 2,
                       "crop_square_resize", "BCE", PnPConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_to_pose_batch(np.zeros((1, 4, 4), np.float32),
                             np.zeros((1, 4, 4, 2), np.float32),
                             lut.points, lut.valid,
                             np.array([[0, 0, 8, 8]], np.int32),
                             np.eye(3, dtype=np.float32)[None], bbox_size=4,
                             generator=torch.Generator())
    # training: the setup and the command
    from zebrapose_tpu_torch import cli
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.train.trainer import build_train_setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_setup(ZebraConfig(), "ape", "unused",
                          pretrained_backbone=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--cfg", "unused.txt", "--obj_name", "ape",
                  "--from_scratch"])
    # the BOP-challenge path: vivo and its scoring
    from zebrapose_tpu_torch.eval.bop_score import score_csv
    from zebrapose_tpu_torch.eval.runner_vivo import run_vivo
    from zebrapose_tpu_torch.ops.bop_errors import vsd_batch
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["vivo", "--cfg", "unused.txt", "--obj_name", "ape",
                  "--ckpt_file", "unused.npz"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_vivo(ZebraConfig(), "ape", "unused.npz", "unused")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        score_csv("unused.csv", "unused", "lmo")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vsd_batch(*[np.zeros((1, 3, 3))] * 4,
                  np.zeros((1, 4, 4), np.float32),
                  np.eye(3)[None], np.zeros((3, 3), np.float32),
                  np.zeros((1, 3), np.int32), 80.0)
    # serving: the exports and the artifacts' drivers; the tools
    for command in (["export-serving", "--obj_name", "ape", "--ckpt_file",
                     "unused.npz", "--out", "unused.serving"],
                    ["visualize", "--obj_name", "ape", "--ckpt_file",
                     "unused.npz", "--scene", "2", "--im", "0"],
                    ["serve-exported", "--obj_name", "ape", "--blob",
                     "unused.serving"],
                    ["serve-exported-fleet", "--obj_names", "ape", "can",
                     "--blob", "unused.serving"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(command + ["--cfg", "unused.txt"])
    for command in (["model-cost"], ["export-ckpt", "--ckpt_file",
                                     "unused.npz", "--out", "unused.pth"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(command)
    # CPU work must be asked for: device="cpu" builds the step
    make_eval_step(lambda b: b, lut, 64, 32, 2, 2, "crop_square_resize",
                   "BCE", PnPConfig(), device="cpu")
    # the kernel wrapper takes its device from the tensors and refuses
    # anything but CPU (plain version) or CUDA (kernel)
    with pytest.raises(ValueError, match="unsupported device"):
        minimal_epnp_hypotheses(torch.zeros(1, 6, 3, device="meta"),
                                torch.zeros(1, 6, 2, device="meta"),
                                torch.zeros(1, 3, 3, device="meta"))

