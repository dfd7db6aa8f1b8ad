"""Serving export: the whole eval program as one `torch.export` artifact.

Port of `zebrapose_tpu/eval/export_serving.py`. The production eval
program (preprocess -> ZebraPoseNet -> binarize -> surface-code decode ->
EPnP-RANSAC, the `make_eval_step` graph, or the fleet's
`make_fleet_eval_step` for K objects) is traced by `torch.export` with
the checkpoint's weights and the correspondence LUT as the program's
state, and saved as one blob. A serving process loads the blob alone: it
builds no model and reads no checkpoint or LUT file. The EPnP hypothesis
stage is the custom op `zebrapose::epnp_minimal_hypotheses`
(`ops/pnp_kernel.py`), one graph node that launches the CUDA kernel when
a CUDA artifact runs.

Interface of the exported program (shapes fixed at export, or a
symbolic batch with batch=None):

    (rgb[B,H,W,3] u8, roi_param[B,5] i32, valid[B] f32,
     final_bbox[B,4] i32, K[B,3,3] f32, prio[B,P_pad] f32,
     u[B,n_hypotheses,sample_size] f32)
        -> (R[B,3,3] f32, t[B,3] f32, success[B] bool, n_inliers[B] i32)

`roi_param` is [B,4] i32 for crop_resize and [B,3] f32 for
crop_resize_by_warp_affine, as `CropDatasetHost.collate` gives it.
`prio` / `u` are the RANSAC uniforms in `RansacDraws` layout, with
P_pad = `subset_pad_len(crop_gt², cfg)` (0 when no subset is built).
They are the port's form of the JAX signature's `key[2] u32`: a
`torch.Generator` cannot be a program input, so the drivers below draw
the uniforms on the host side of the call, with
`ops/pnp.py::draw_ransac_uniforms` from `batch_generator(seed, start)`
(the fleet: `fleet_generator(seed, start, k)`). Those are the uniforms
the live step draws, so a fixed-batch artifact gives the live path's
poses at the same batch size. A fleet program (n_models = K) takes
flat [K·B, ...] frame rows in object-major order, prio [K,B,P_pad] and
u [K,B,n_hypotheses,sample_size], and returns [K,B,...].

A torch.export program is bound to the device it was traced on (its
weights live there), so a blob records that device: a CUDA blob on a
host without CUDA is refused, never run on the CPU. The JAX package's
`platforms` (cross-lowering) and `use_kernel` have no counterpart.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
from zebrapose_tpu_torch.eval.evaluate import (
    batch_generator,
    make_eval_step,
    run_inference,
)
from zebrapose_tpu_torch.ops.pnp import (
    PnPConfig,
    RansacDraws,
    draw_ransac_uniforms,
    subset_pad_len,
)
from zebrapose_tpu_torch.utils.device import resolve_device

MAGIC = b"ZEBRAPOSE_TORCH_SERVING_V1\n"
# blob layout: MAGIC, one JSON metadata line ({"n_models": K, ...}),
# then the torch.export.save payload.

def _roi_spec(resize_method: str) -> Tuple[int, torch.dtype]:
    """(columns, dtype) of roi_param for a resize method."""
    return {"crop_square_resize": (5, torch.int32),
            "crop_resize": (4, torch.int32),
            "crop_resize_by_warp_affine": (3, torch.float32)}[resize_method]


class _ServingBase(torch.nn.Module):
    """What every serving module records for export: the frame rows per
    batch row (n_models), the draw shapes and the roi_param layout."""

    def _setup(self, crop_gt: int, resize_method: str, pnp_cfg: PnPConfig,
               n_models: int, device: torch.device):
        self.n_models = n_models
        self.pnp_cfg = pnp_cfg
        self.n_points = crop_gt * crop_gt
        self.resize_method = resize_method
        self.device = device


class ServingModule(_ServingBase):
    """The production eval step (`make_eval_step`) of one object as a
    module: the model's weights and the LUT are its state, the RANSAC
    uniforms are inputs."""

    def __init__(self, model: torch.nn.Module, step: Callable,
                 crop_gt: int, resize_method: str, pnp_cfg: PnPConfig,
                 device: torch.device):
        super().__init__()
        self.model = model
        points, valid = step.lut
        self.register_buffer("lut_points", points)
        self.register_buffer("lut_valid", valid)
        self._step = step
        self._setup(crop_gt, resize_method, pnp_cfg, 1, device)

    def forward(self, rgb, roi_param, valid, final_bbox, K, prio, u):
        raw = {"rgb": rgb, "roi_param": roi_param, "valid": valid}
        return self._step(raw, final_bbox, K,
                          draws=RansacDraws(prio=prio, u=u),
                          lut_tensors=(self.lut_points, self.lut_valid))


def build_serving_fn(model: torch.nn.Module, lut: CorrespondenceLUT,
                     crop_img: int, crop_gt: int, base: int, n_bits: int,
                     resize_method: str, loss_type: str,
                     pnp_cfg: PnPConfig, ignore_bits: int = 0,
                     mask_from_dataset: bool = False,
                     device=None) -> ServingModule:
    """The production eval step closed over `model` (its weights, in its
    dtype: a bf16 model runs the forward in bf16) and the LUT, as a
    module for `export_serving`. It wraps `make_eval_step` itself, so
    the serving graph is the production graph by construction.
    `mask_from_dataset` (the Mask-RCNN variant) reads the dataset's mask
    channel, which is not part of the serving signature: refused."""
    if mask_from_dataset:
        raise ValueError(
            "mask_from_dataset consumes the dataset's rasterized GT/RLE "
            "mask channel, which is not part of the serving signature; "
            "export the network-mask variant instead")
    dev = resolve_device(device)
    dtype = next(model.parameters()).dtype
    step = make_eval_step(
        lambda b: model(b["image"].to(dtype)), lut, crop_img=crop_img,
        crop_gt=crop_gt, base=base, n_bits=n_bits,
        resize_method=resize_method, loss_type=loss_type, pnp_cfg=pnp_cfg,
        ignore_bits=ignore_bits, preprocess_gt=False, device=dev)
    return ServingModule(model, step, crop_gt, resize_method, pnp_cfg, dev)


class FleetServingModule(_ServingBase):
    """The fleet eval step (`make_fleet_eval_step`) of K objects as a
    module: the stacked weights (one buffer a tensor name) and the
    stacked LUTs are its state."""

    def __init__(self, step: Callable, variables: Dict[str, torch.Tensor],
                 crop_gt: int, resize_method: str, pnp_cfg: PnPConfig,
                 n_models: int, device: torch.device):
        super().__init__()
        self._names = {}
        for i, (name, value) in enumerate(variables.items()):
            self._names[name] = f"v{i}"
            self.register_buffer(f"v{i}", value)
        points, valid = step.luts
        self.register_buffer("lut_points", points)
        self.register_buffer("lut_valid", valid)
        self._step = step
        self._setup(crop_gt, resize_method, pnp_cfg, n_models, device)

    def forward(self, rgb, roi_param, valid, final_bbox, K, prio, u):
        raw = {"rgb": rgb, "roi_param": roi_param, "valid": valid}
        variables = {n: getattr(self, b) for n, b in self._names.items()}
        draws = [RansacDraws(prio=prio[k], u=u[k])
                 for k in range(self.n_models)]
        return self._step(raw, final_bbox, K, variables, draws=draws,
                          luts=(self.lut_points, self.lut_valid))


def build_fleet_serving_fn(model: torch.nn.Module,
                           variables: Dict[str, torch.Tensor],
                           luts: Sequence[CorrespondenceLUT],
                           crop_img: int, crop_gt: int, base: int,
                           n_bits: int, resize_method: str, loss_type: str,
                           pnp_cfg: PnPConfig, bf16: bool = False,
                           device=None) -> FleetServingModule:
    """K per-object models in ONE module (the fleet program: stacked
    weights and LUTs, the K members' forwards, K decodes with one kernel
    launch each). `model` is the members' architecture (its own weights
    are never read; `eval/fleet_serve.py::_fleet_model` makes it on the
    meta device), `variables` the stacked state (`stack_variables`).
    The forwards run in turn (`make_fleet_eval_step(vmap_forward=
    False)`): torch.export's graph of the vmapped forward holds a
    functorch call that torch 2.11's serializer refuses. bf16 casts the
    stacked floating-point state and the image to bf16, as
    `build_serving_fn` runs a bf16 model (`cast_variables`: an int8
    `model`'s quantized convs keep f32 parameters). Inputs are flat
    [K·B, ...] rows in object-major order; outputs are [K, B, ...]."""
    from zebrapose_tpu_torch.eval.fleet_serve import (
        make_fleet_eval_step,
        model_forward,
        stack_luts,
    )

    dev = resolve_device(device)
    lp, lv = stack_luts(luts)
    dtype = torch.bfloat16 if bf16 else torch.float32
    if bf16:
        from zebrapose_tpu_torch.models.layers import cast_variables

        variables = cast_variables(model, variables, dtype)
    forward = model_forward(model)
    step = make_fleet_eval_step(
        lambda b, v: forward({"image": b["image"].to(dtype)}, v), lp, lv,
        crop_img=crop_img, crop_gt=crop_gt, base=base, n_bits=n_bits,
        resize_method=resize_method, loss_type=loss_type, pnp_cfg=pnp_cfg,
        vmap_forward=False, device=dev)
    return FleetServingModule(step, variables, crop_gt, resize_method,
                              pnp_cfg, len(luts), dev)


def _example_inputs(module: _ServingBase, batch: int,
                    image_hw: Tuple[int, int]):
    h, w = image_hw
    k = module.n_models
    dev = module.device
    n_pad = subset_pad_len(module.n_points, module.pnp_cfg)
    cols, roi_dtype = _roi_spec(module.resize_method)
    rows = (k * batch,)
    draws = (batch,) if k == 1 else (k, batch)
    cfg = module.pnp_cfg
    return (torch.zeros(rows + (h, w, 3), dtype=torch.uint8, device=dev),
            torch.ones(rows + (cols,), dtype=roi_dtype, device=dev),
            torch.ones(rows, dtype=torch.float32, device=dev),
            torch.ones(rows + (4,), dtype=torch.int32, device=dev),
            torch.eye(3, device=dev).expand(rows + (3, 3)).contiguous(),
            torch.zeros(draws + (n_pad,), device=dev),
            torch.zeros(draws + (cfg.n_hypotheses, cfg.sample_size),
                        device=dev))


def export_serving(module: _ServingBase, batch: Optional[int],
                   image_hw: Tuple[int, int],
                   meta: Optional[dict] = None) -> bytes:
    """Trace `module` (`build_serving_fn` / `build_fleet_serving_fn`) with
    `torch.export` at a fixed frame shape on its device and serialize it:
    MAGIC, one JSON metadata line, then the `torch.export.save` payload
    (the weights make it checkpoint-sized). `batch` is per model;
    batch=None exports a symbolic batch dimension (one blob serves any
    per-model batch size)."""
    k = module.n_models
    example = _example_inputs(module, batch or 2, image_hw)
    dynamic = None
    if batch is None:
        # sizes 0 and 1 are specialized by torch.export; ServingProgram
        # pads a batch of one to two
        b = torch.export.Dim("batch", min=2, max=65535)
        dynamic = (({0: b},) * 7 if k == 1
                   else ({0: k * b},) * 5 + ({1: b},) * 2)
    with torch.no_grad():
        program = torch.export.export(module, example,
                                      dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    header = dict(meta or {})
    header.update(
        n_models=k, poly_batch=batch is None, batch=batch,
        image_hw=list(image_hw), device=str(module.device),
        resize_method=module.resize_method, n_points=module.n_points,
        pnp=dataclasses.asdict(module.pnp_cfg), torch=torch.__version__)
    return MAGIC + json.dumps(header).encode() + b"\n" + buf.getvalue()


class ServingProgram:
    """A loaded serving artifact: callable with the serving signature
    (tensors on `device`), plus its metadata. `batch` is per model (None
    for a symbolic-batch artifact); `rows` the flat row count."""

    def __init__(self, program, meta: dict):
        self.program = program
        self._fn = program.module()
        self.meta = meta
        self.n_models = int(meta.get("n_models", 1))
        self.device = torch.device(meta["device"])
        self.batch = meta.get("batch")
        self.rows = None if self.batch is None else \
            self.batch * self.n_models
        self.image_hw = tuple(int(d) for d in meta["image_hw"])
        self.pnp_cfg = PnPConfig(**meta["pnp"])
        self.n_points = int(meta["n_points"])
        self._roi_dtype = _roi_spec(meta["resize_method"])[1]

    def __call__(self, *args):
        """The program on the serving signature's inputs. A symbolic-batch
        program takes a batch of two or more: a batch of one gets a copy
        of its row an object, cut off the outputs. A copy, not a zero
        row: an int8 program's activation scale is the max over the
        batch, which a copy leaves as the row's own, so the lone crop is
        posed as a batch-1 program would pose it."""
        k = self.n_models
        one = self.batch is None and args[0].shape[0] == k
        if one:
            def pad(x, flat):
                x = x.reshape((k, 1) + x.shape[1 if flat else 2:])
                x = torch.cat([x, x], 1)
                return x.flatten(0, 1) if flat else x

            args = [pad(x, True) for x in args[:5]] + \
                [pad(x, k == 1) for x in args[5:]]
        with torch.no_grad():
            out = self._fn(*args)
        if one:
            out = tuple(x[:1] if k == 1 else x[:, :1] for x in out)
        return out

    def draws(self, generator: torch.Generator, batch: int) -> RansacDraws:
        """The RANSAC uniforms of one object's batch from `generator`,
        as the live step would draw them."""
        return draw_ransac_uniforms(generator, batch, self.n_points,
                                    self.pnp_cfg)

    def frame_args(self, feed, final_bbox, K):
        """A runner feed marshalled into the signature's frame inputs on
        the program's device."""
        dev = self.device

        def t(x, dtype):
            return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

        return (t(feed["rgb"], torch.uint8),
                t(feed["roi_param"], self._roi_dtype),
                t(feed["valid"], torch.float32),
                t(final_bbox, torch.int32), t(K, torch.float32))


def load_serving(blob_or_path, device=None) -> ServingProgram:
    """Deserialize an export_serving blob (raw bytes or a path) on
    `device` (CUDA unless "cpu" is asked for), which must be the device
    it was exported on. Shapes must match the export; pad the tail batch
    as the runners do (`serve_dataset` does)."""
    # registers the custom ops the program calls:
    # zebrapose::epnp_minimal_hypotheses, and for an int8 program
    # zebrapose::quantize_act and zebrapose::int8_conv2d
    import zebrapose_tpu_torch.ops.int8_conv  # noqa: F401
    import zebrapose_tpu_torch.ops.pnp_kernel  # noqa: F401

    if isinstance(blob_or_path, (bytes, bytearray)):
        blob = bytes(blob_or_path)
    else:
        with open(blob_or_path, "rb") as f:
            blob = f.read()
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError("not a zebrapose serving artifact (bad header)")
    rest = blob[len(MAGIC):]
    nl = rest.index(b"\n")
    meta = json.loads(rest[:nl])
    made_for = torch.device(meta["device"])
    if made_for.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the artifact was exported for {made_for} and this host has "
            "no CUDA device; a torch.export program runs on the device it "
            "was traced on (re-export with --device cpu to serve on the "
            "CPU)")
    dev = resolve_device(device)
    if dev.type != made_for.type:
        raise ValueError(f"the artifact was exported for {made_for}, not "
                         f"{dev}; serve it there or re-export it")
    program = torch.export.load(io.BytesIO(rest[nl + 1:]))
    return ServingProgram(program, meta)


def _check_frame_size(prog: ServingProgram, *datasets) -> None:
    """Fail with an actionable message (not a deep shape error) when the
    split's frames don't match the artifact's. For a roi_slice artifact
    (exported at the walk's buffer dims), first switch every dataset to
    roi_slice with the blob's buffer; `set_slice_hw`'s check turns an
    undersized buffer into a loud error instead of dropped pixels."""
    if prog.meta.get("roi_slice"):
        for ds in datasets:
            if ds.resize_method != "crop_square_resize":
                raise ValueError("roi_slice supports crop_square_resize "
                                 "only")
            ds.roi_slice = True
            ds.set_slice_hw(prog.image_hw)
    for ds in datasets:
        if len(ds) == 0:
            continue
        hw = tuple(ds.get_raw(0)["rgb"].shape[:2])
        if hw != prog.image_hw:
            raise ValueError(
                f"artifact was exported for frames {prog.image_hw}, "
                f"split ships {hw} — re-export with "
                f"--image_h/--image_w")


def serve_dataset(prog: ServingProgram, dataset, seed: int = 0,
                  batch_size: int = 16,
                  timing: Optional[Dict[str, float]] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run a CropDatasetHost walk through a loaded serving program:
    literally `run_inference` (producer-thread collate, zero-padded tail
    batch with valid = 0, fetched a batch late) with the program in place
    of the eval step and the uniforms of `batch_generator(seed, start)`
    as its draw inputs, so a fixed-batch blob reproduces `run_test`'s
    poses at the same batch size. Returns (R [N,3,3], t [N,3], success
    [N]). batch_size applies to symbolic-batch artifacts only."""
    if prog.n_models != 1:
        raise ValueError("fleet artifact: use serve_fleet_datasets")
    bsz = prog.batch or batch_size

    def draws_for(start):
        return prog.draws(batch_generator(seed, start, prog.device), bsz)

    def step(feed, final_bbox, K, draws):
        return prog(*prog.frame_args(feed, final_bbox, K), draws.prio,
                    draws.u)

    return run_inference(dataset, step, batch_size=bsz, seed=seed,
                         device=prog.device, draws_for=draws_for,
                         timing=timing)


def serve_fleet_datasets(prog: ServingProgram, datasets, seed: int = 0,
                         batch_size: int = 16,
                         timing: Optional[Dict[str, float]] = None
                         ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                    List[np.ndarray]]:
    """Drive K per-object dataset walks through a loaded FLEET artifact:
    literally `fleet_infer` (lockstep, valid = 0 padding) with the blob
    in place of the fleet step and object k's uniforms from
    `fleet_generator(seed, start, k)`. Returns per-object (Rs, ts, ok).
    batch_size applies to symbolic-batch artifacts only."""
    from zebrapose_tpu_torch.eval.fleet_serve import (
        fleet_generator,
        fleet_infer,
    )

    if prog.n_models != len(datasets):
        raise ValueError(f"artifact serves {prog.n_models} models, got "
                         f"{len(datasets)} datasets")
    bsz = prog.batch or batch_size

    def draws_for(start):
        return [prog.draws(fleet_generator(seed, start, k, prog.device), bsz)
                for k in range(prog.n_models)]

    def step(feed, final_bbox, K, variables, draws):
        return prog(*prog.frame_args(feed, final_bbox, K),
                    torch.stack([d.prio for d in draws]),
                    torch.stack([d.u for d in draws]))

    return fleet_infer(datasets, step, None, bsz, seed=seed,
                       device=prog.device, draws_for=draws_for,
                       timing=timing)


def _csv(output_dir: str, cfg, name: str, obj_id: int, dataset, Rs, ts,
         scores) -> str:
    from zebrapose_tpu_torch.data.bop_writer import parse_sample_ids, write_csv

    ids = parse_sample_ids(dataset.rgb_files)
    return write_csv(os.path.join(output_dir, "pose_result_bop"),
                     f"{cfg.dataset_name}_{name}", obj_id,
                     [s for s, _ in ids], [im for _, im in ids], list(Rs),
                     [t.reshape(3, 1) for t in ts], scores)


def run_serve_exported(cfg, obj_name: str, blob_path: str,
                       output_dir: str, seed: int = 0,
                       max_samples: Optional[int] = None,
                       batch_size: int = 16, device=None) -> dict:
    """Deployment-shaped run: walk the configured test split with the
    detections the config names, answer every instance from the serving
    blob alone (no checkpoint, no model build), write the BOP CSV.

    The dataset walk, draws, tail padding and failed-pose rows (identity
    R / zero t) all match `run_test`'s, so a fixed-batch f32 blob
    exported from the same checkpoint at run_test's batch size
    reproduces its CSV byte for byte on the CPU."""
    from zebrapose_tpu_torch.eval.runner import prepare_object_eval

    t0 = time.perf_counter()
    prog = load_serving(blob_path, device)
    load_s = time.perf_counter() - t0
    if prog.n_models != 1:
        raise ValueError("fleet artifact: use run_serve_exported_fleet / "
                         "serve-exported-fleet")
    oe = prepare_object_eval(cfg, obj_name, max_samples=max_samples)
    _check_frame_size(prog, oe.dataset)
    timing: Dict[str, float] = {}
    Rs, ts, ok = serve_dataset(prog, oe.dataset, seed=seed,
                               batch_size=batch_size, timing=timing)
    Rs[~ok] = np.eye(3)      # reference: identity R / zero t in the CSV
    ts[~ok] = 0
    _csv(output_dir, cfg, obj_name, oe.obj_id, oe.dataset, Rs, ts,
         oe.scores if oe.scores is not None else [1.0] * len(oe.dataset))
    print("timing " + json.dumps(timing))
    return {"instances": int(len(oe.dataset)), "solved": int(ok.sum()),
            "batch": prog.batch, "device": str(prog.device),
            "load_s": load_s}


def _vivo_dataset_for(cfg, obj_name: str, score_threshold: float):
    """Shared vivo walk for the blob drivers: images from
    scene_camera.json + the config's detections, flattened to one
    object's (image, instance) dataset (`eval/vivo.py`)."""
    from zebrapose_tpu_torch.data import bop_io
    from zebrapose_tpu_torch.data import detections as det_mod
    from zebrapose_tpu_torch.data.dataset_info import lookup_obj_id
    from zebrapose_tpu_torch.eval.vivo import build_vivo_dataset

    rgb_files, cam_by_file = bop_io.list_images_with_cameras(
        cfg.bop_path, cfg.dataset_name, data_folder=cfg.test_folder)
    dets = det_mod.load_detections(cfg.Detection_reaults)
    obj_id = lookup_obj_id(cfg.dataset_name, obj_name)
    dataset, scores = build_vivo_dataset(
        os.path.join(cfg.bop_path, cfg.dataset_name), cfg.test_folder,
        rgb_files, cam_by_file, dets, obj_id, score_threshold,
        crop_size_img=cfg.BoundingBox_CropSize_image,
        crop_size_gt=cfg.BoundingBox_CropSize_GT,
        padding_ratio=cfg.padding_ratio,
        resize_method=cfg.resize_method)
    return obj_id, dataset, scores


def run_serve_exported_vivo(cfg, obj_name: str, blob_path: str,
                            output_dir: str, seed: int = 0,
                            score_threshold: float = 0.2,
                            batch_size: int = 16, device=None) -> dict:
    """Deployment-shaped multi-instance run: walk the split's images from
    scene_camera.json + detections alone (GT-less, reference
    test_vivo.py:127-131 semantics) and answer every detected instance of
    the object from the serving blob. The CSV carries detector scores
    with failed instances dropped (`evaluate_vivo` semantics). The blob's
    mask head gates the decode: its signature has no dataset-mask input,
    so the --mask_rcnn variant needs the live `vivo` command."""
    t0 = time.perf_counter()
    prog = load_serving(blob_path, device)
    load_s = time.perf_counter() - t0
    if prog.n_models != 1:
        raise ValueError("fleet artifact: use run_serve_exported_vivo_"
                         "fleet / serve-exported-fleet --vivo")
    obj_id, dataset, scores = _vivo_dataset_for(cfg, obj_name,
                                                score_threshold)
    _check_frame_size(prog, dataset)
    timing: Dict[str, float] = {}
    Rs, ts, ok = serve_dataset(prog, dataset, seed=seed,
                               batch_size=batch_size, timing=timing)
    _csv(output_dir, cfg, obj_name, obj_id, dataset, Rs, ts,
         [s if k else -1 for s, k in zip(scores, ok)])
    print("timing " + json.dumps(timing))
    return {"instances": int(len(dataset)), "solved": int(ok.sum()),
            "batch": prog.batch, "device": str(prog.device),
            "load_s": load_s}


def run_serve_exported_fleet(cfg, obj_names: List[str], blob_path: str,
                             output_dir: str, seed: int = 0,
                             max_samples: Optional[int] = None,
                             batch_size: int = 16, device=None) -> dict:
    """Deployment-shaped fleet run: answer K objects' test splits from
    one fleet artifact; per-object BOP CSVs + one merged submission CSV
    (`run_test_fleet`'s artifact set, minus metrics: serving is
    GT-less)."""
    from zebrapose_tpu_torch.data import bop_io
    from zebrapose_tpu_torch.data.bop_writer import merge_csv
    from zebrapose_tpu_torch.eval.runner import prepare_object_eval

    t0 = time.perf_counter()
    prog = load_serving(blob_path, device)
    load_s = time.perf_counter() - t0
    if prog.n_models != len(obj_names):
        raise ValueError(f"artifact serves {prog.n_models} models, got "
                         f"{len(obj_names)} object names")
    shared = None if cfg.bop_challange else bop_io.get_dataset(
        cfg.bop_path, cfg.dataset_name, train=False, eval_model=True,
        data_folder=cfg.test_folder)
    oes = [prepare_object_eval(cfg, n, max_samples=max_samples,
                               samples=shared) for n in obj_names]
    for name, oe in zip(obj_names, oes):
        if len(oe.dataset) == 0:
            raise ValueError(f"object {name}: empty eval split")
    _check_frame_size(prog, *[oe.dataset for oe in oes])
    timing: Dict[str, float] = {}
    Rs, ts, ok = serve_fleet_datasets(prog, [oe.dataset for oe in oes],
                                      seed=seed, batch_size=batch_size,
                                      timing=timing)
    csvs, solved = [], {}
    for i, (name, oe) in enumerate(zip(obj_names, oes)):
        Rs[i][~ok[i]] = np.eye(3)       # reference: identity R / zero t
        ts[i][~ok[i]] = 0
        csvs.append(_csv(output_dir, cfg, name, oe.obj_id, oe.dataset,
                         Rs[i], ts[i], oe.scores if oe.scores is not None
                         else [1.0] * len(oe.dataset)))
        solved[name] = int(ok[i].sum())
    merged = merge_csv(csvs, os.path.join(
        output_dir, f"{cfg.dataset_name}_fleet.csv"))
    print("timing " + json.dumps(timing))
    return {"solved": solved,
            "instances": {n: int(len(oe.dataset))
                          for n, oe in zip(obj_names, oes)},
            "batch": prog.batch, "merged_csv": merged, "load_s": load_s}


def run_serve_exported_vivo_fleet(cfg, obj_names: List[str],
                                  blob_path: str, output_dir: str,
                                  seed: int = 0,
                                  score_threshold: float = 0.2,
                                  batch_size: int = 16,
                                  device=None) -> dict:
    """Multi-instance fleet run from one fleet artifact. The blob holds
    exactly n_models models on its model axis, so every object must have
    at least one detected instance: an empty object cannot be skipped
    without breaking the axis correspondence (lower the threshold, or use
    the live `vivo-fleet`, which skips empties)."""
    from zebrapose_tpu_torch.data.bop_writer import merge_csv

    t0 = time.perf_counter()
    prog = load_serving(blob_path, device)
    load_s = time.perf_counter() - t0
    if prog.n_models != len(obj_names):
        raise ValueError(f"artifact serves {prog.n_models} models, got "
                         f"{len(obj_names)} object names")
    walks = [_vivo_dataset_for(cfg, n, score_threshold)
             for n in obj_names]
    for name, (_, ds, _) in zip(obj_names, walks):
        if len(ds) == 0:
            raise ValueError(
                f"object {name}: no detection above score "
                f"{score_threshold}; a fleet blob cannot skip an object "
                "(fixed model axis) — lower the threshold or use the "
                "live vivo-fleet command")
    _check_frame_size(prog, *[ds for _, ds, _ in walks])
    timing: Dict[str, float] = {}
    Rs, ts, ok = serve_fleet_datasets(prog, [ds for _, ds, _ in walks],
                                      seed=seed, batch_size=batch_size,
                                      timing=timing)
    csvs, per_object = [], {}
    for i, (name, (obj_id, dataset, scores)) in enumerate(
            zip(obj_names, walks)):
        csvs.append(_csv(output_dir, cfg, name, obj_id, dataset, Rs[i],
                         ts[i], [s if k else -1
                                 for s, k in zip(scores, ok[i])]))
        per_object[name] = {"instances": int(len(dataset)),
                            "solved": int(ok[i].sum())}
    merged = merge_csv(csvs, os.path.join(
        output_dir, f"{cfg.dataset_name}_vivo_fleet.csv"))
    print("timing " + json.dumps(timing))
    return {"per_object": per_object, "batch": prog.batch,
            "merged_csv": merged, "load_s": load_s}
