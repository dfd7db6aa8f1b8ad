"""Single-instance evaluation: the reference test.py pipeline, batched.

Port of `zebrapose_tpu/eval/evaluate.py`. `make_eval_step` builds the
inference program: preprocess -> forward -> binarize -> surface-code
decode -> EPnP-RANSAC over a fixed batch, crops never leaving the device
until the final pose tensors. PyTorch runs it eagerly; the one
hand-written kernel on the path is the RANSAC hypothesis stage
(`ops/pnp_kernel.py`). `run_inference` streams a host dataset through
it, `pose_errors` / `summarize` score the poses (ADD or ADD-S, recall
at {0.1, 0.05, 0.02}d, step-AUC, posecnn-AUC) and `evaluate_object`
writes the reference artifact set (BOP CSV, add_err.txt,
ADD_result.txt; test.py:465-561).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue as queue_mod
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from zebrapose_tpu_torch.codec.lut import (
    CorrespondenceLUT,
    reduce_lut_ignore_bits,
)
from zebrapose_tpu_torch.data.bop_writer import parse_sample_ids, write_csv
from zebrapose_tpu_torch.data.pipeline import (
    FEED_KEYS,
    CropDatasetHost,
    preprocess_batch,
)
from zebrapose_tpu_torch.ops.binarize import code_from_logits, mask_from_logits
from zebrapose_tpu_torch.ops.metrics import (
    add_error,
    adi_error,
    auc_posecnn,
    auc_step,
    recall_at,
)
from zebrapose_tpu_torch.ops.pnp import (
    PnPConfig,
    RansacDraws,
    decode_to_pose_batch,
)
from zebrapose_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class EvalResult:
    rotations: np.ndarray        # [N, 3, 3]
    translations: np.ndarray     # [N, 3]
    success: np.ndarray          # [N] bool
    errors: np.ndarray           # [N] ADD or ADD-S (10000 on failure)
    metrics: Dict[str, float]
    # seconds by stage of this run (run_inference's, plus pose_errors_s
    # and write_s)
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)


def _pad_to(arrs: Dict[str, np.ndarray], size: int) -> Dict[str, np.ndarray]:
    """Zero-pad every array's leading axis to `size` (fixed batch)."""
    n = next(iter(arrs.values())).shape[0]
    if n == size:
        return arrs
    return {k: np.pad(v, [(0, size - n)] + [(0, 0)] * (v.ndim - 1))
            for k, v in arrs.items()}


def make_eval_step(forward_fn: Callable[[Dict[str, torch.Tensor]],
                                        Dict[str, torch.Tensor]],
                   lut: CorrespondenceLUT, crop_img: int, crop_gt: int,
                   base: int, n_bits: int, resize_method: str,
                   loss_type: str, pnp_cfg: PnPConfig,
                   ignore_bits: int = 0, return_masks: bool = False,
                   return_codes: bool = False,
                   mask_from_dataset: bool = False,
                   preprocess_gt: bool = True, device=None):
    """Build the batch program step(raw, final_bbox, K, generator=None,
    draws=None) -> (R [B,3,3], t [B,3], success [B], n_inliers [B])
    (+ (visible, entire) masks with return_masks, + codes with
    return_codes).

    forward_fn(batch) -> {"mask", "code", ...} logits (NHWC); for the
    model use `lambda b: model(b["image"])`, casting the image to the
    model's dtype for a bf16 model. Logits are taken to float32 before
    binarization. `raw` holds the arrays of `preprocess_batch` (numpy or
    tensors); everything is moved to `device` (CUDA unless "cpu" is
    asked for). RANSAC draws come from `draws` when given, else from
    `generator` (a torch.Generator on the device). The step's LUT tensors
    are `step.lut` (points, valid); `lut_tensors` replaces them for one
    call (an exported serving module passes its own buffers). With
    `draws` the step traces under `torch.export` at a fixed or symbolic
    batch (`eval/export_serving.py`).
    """
    dev = resolve_device(device)
    if ignore_bits:
        lut = reduce_lut_ignore_bits(lut, ignore_bits)
    lut_points = torch.as_tensor(lut.points, device=dev)
    lut_valid = torch.as_tensor(lut.valid, device=dev)

    @torch.no_grad()
    def step(raw, final_bbox, K,
             generator: Optional[torch.Generator] = None,
             draws: Optional[RansacDraws] = None,
             lut_tensors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        points, valid = lut_tensors or (lut_points, lut_valid)
        raw = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        batch = preprocess_batch(
            raw, crop_img=crop_img, crop_gt=crop_gt, base=base,
            n_bits=n_bits, resize_method=resize_method,
            include_gt=preprocess_gt or mask_from_dataset)
        out = {k: v.float() for k, v in forward_fn(batch).items()}
        if mask_from_dataset:
            # the detector's mask replaces the network's mask head
            masks = (batch["mask"] > 0.5).to(torch.float32)
        else:
            masks = mask_from_logits(out["mask"][..., 0])
        codes = code_from_logits(out["code"], loss_type, base=base)
        if ignore_bits:
            codes = codes[..., :n_bits - ignore_bits]
        # `valid` zeroes dummy / detection-less samples
        poses = decode_to_pose_batch(
            masks * raw["valid"].to(torch.float32)[:, None, None], codes,
            points, valid, torch.as_tensor(final_bbox, device=dev),
            torch.as_tensor(K, device=dev, dtype=torch.float32),
            bbox_size=crop_gt, base=base,
            cfg=pnp_cfg, generator=generator, draws=draws, device=dev)
        extra = ()
        if return_masks:
            if mask_from_dataset:
                entire = (batch["entire_mask"] > 0.5).to(torch.float32)
            else:
                entire = mask_from_logits(
                    out.get("entire_mask", out["mask"])[..., 0])
            extra = (masks, entire)
        if return_codes:
            extra = extra + (codes,)
        return tuple(poses) + extra

    step.lut = (lut_points, lut_valid)
    return step


def batch_generator(seed: int, start: int, device) -> torch.Generator:
    """The RANSAC generator of the batch that starts at sample `start`:
    a generator on `device` seeded from (seed, start), as JAX folds
    `start` into the run's key."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) << 32) + int(start))


@contextlib.contextmanager
def prefetched(collate: Callable, starts: Sequence[int], num_workers: int,
               clock: Dict[str, float]):
    """Collate batches ahead of the device loop: a producer thread runs
    `collate(start, pool)` for each start into a queue of two (reads on a
    pool of `num_workers` threads; 0 = in the producer), and the block
    gets an iterator of (start, batch). `clock["collate_s"]` adds the
    producer's collates, `clock["wait_s"]` the loop's waits for a batch.
    A producer's error is raised in the loop; neither the producer nor
    the pool outlives the block."""
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
    stop = threading.Event()
    pool = ThreadPoolExecutor(max_workers=num_workers) \
        if num_workers > 0 else None

    def _put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=1.0)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            for start in starts:
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                item = collate(start, pool)
                clock["collate_s"] += time.perf_counter() - t0
                if not _put((start, item)):
                    return
            _put(None)
        except BaseException as e:  # handed to the consumer, re-raised
            _put(e)

    def batches():
        while True:
            t0 = time.perf_counter()
            item = q.get()
            clock["wait_s"] += time.perf_counter() - t0
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        yield batches()
        thread.join()
    except BaseException:
        # stop and unblock the producer so it does not outlive the block
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue_mod.Empty:
            pass
        thread.join(timeout=10.0)
        raise
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


def run_inference(dataset: CropDatasetHost, eval_step,
                  batch_size: int = 16, seed: int = 0,
                  num_workers: int = 4, device=None,
                  draws_for: Optional[Callable[[int], RansacDraws]] = None,
                  timing: Optional[Dict[str, float]] = None,
                  collect_masks: bool = False,
                  collect_codes: bool = False):
    """Run the eval step over the dataset: (R [N,3,3], t [N,3], success
    [N]) as numpy, plus (visible masks, entire masks) [N,h,w] with
    `collect_masks` (a step made with return_masks=True), plus the codes
    [N,h,w,n_bits] with `collect_codes` (return_codes=True).

    A producer thread collates batches into a bounded queue (PNG decode
    on a pool of `num_workers` threads; 0 = inline), the last batch is
    zero-padded to `batch_size`, and each batch's outputs are fetched
    one batch late, so host decode, device compute and the copies back
    overlap. RANSAC draws come from `batch_generator(seed, start)` on
    the device, or from `draws_for(start)` when given (tests inject the
    JAX package's draws that way).

    `timing`, when given, is filled with seconds of this run:
    inference_s (the whole call), collate_s (the producer's collates,
    which overlap the rest), wait_s (the device loop waiting for a
    collated batch), step_s (the host issuing eval_step), fetch_s
    (copying poses back, waiting for the device), and on CUDA device_s
    (each step's span on the device stream, by CUDA events).
    """
    dev = resolve_device(device)
    t_run = time.perf_counter()
    clock = dict.fromkeys(("collate_s", "wait_s", "step_s", "fetch_s"), 0.0)
    spans = []
    n = len(dataset)
    Rs = np.zeros((n, 3, 3), np.float32)
    ts = np.zeros((n, 3), np.float32)
    ok = np.zeros((n,), bool)
    extra = ([] if not collect_masks else [[], []]) + \
        ([] if not collect_codes else [[]])

    def collate(start, pool):
        idx = list(range(start, min(start + batch_size, n)))
        return len(idx), _pad_to(dataset.collate(idx, executor=pool),
                                 batch_size)

    def consume(start, m, out):
        t0 = time.perf_counter()
        Rs[start:start + m] = out[0][:m].cpu().numpy()
        ts[start:start + m] = out[1][:m].cpu().numpy()
        ok[start:start + m] = out[2][:m].cpu().numpy()
        for got, x in zip(extra, out[4:]):
            got.extend(x[:m].cpu().numpy())
        clock["fetch_s"] += time.perf_counter() - t0

    pending = None
    with prefetched(collate, range(0, n, batch_size), num_workers,
                    clock) as batches:
        for start, (m, raw) in batches:
            feed = {k: raw[k] for k in FEED_KEYS}
            kw = ({"draws": draws_for(start)} if draws_for is not None
                  else {"generator": batch_generator(seed, start, dev)})
            t0 = time.perf_counter()
            if dev.type == "cuda":
                spans.append((torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True)))
                spans[-1][0].record()
            out = eval_step(feed, raw["final_bbox"].astype(np.int32),
                            raw["K"], **kw)
            if spans:
                spans[-1][1].record()
            clock["step_s"] += time.perf_counter() - t0
            if pending is not None:
                consume(*pending)
            pending = (start, m, out)
        if pending is not None:
            consume(*pending)
    if timing is not None:
        timing.update(clock, inference_s=time.perf_counter() - t_run)
        if spans:
            timing["device_s"] = sum(a.elapsed_time(b)
                                     for a, b in spans) / 1e3
    return (Rs, ts, ok) + tuple(np.array(x) for x in extra)


def pose_errors(dataset: CropDatasetHost, Rs, ts, ok,
                vertices: np.ndarray, symmetric: bool,
                chunk: int = 256, device=None) -> np.ndarray:
    """Per-sample ADD (or ADD-S if symmetric); 10000 on failure and for
    samples without GT (test.py:465-476). Computed on the device,
    `chunk` poses at a time; ADD-S's [chunk, 512, V] distance block is
    kept near 512 MB by shrinking the chunk."""
    dev = resolve_device(device)
    n = len(dataset)
    errs = np.full((n,), 10000.0, np.float64)
    idx = np.array([i for i in range(n)
                    if ok[i] and dataset.gts[i] is not None], np.int64)
    if idx.size == 0:
        return errs
    v = torch.as_tensor(np.asarray(vertices, np.float32), device=dev)
    if symmetric:
        chunk = max(1, min(chunk, (2 ** 27) // (512 * max(v.shape[0], 1))))
    err_fn = adi_error if symmetric else add_error

    def dev32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    Re, te = dev32(np.asarray(Rs)[idx]), dev32(np.asarray(ts)[idx])
    Rg = dev32(np.stack([np.asarray(dataset.gts[i]["cam_R_m2c"],
                                    np.float32).reshape(3, 3) for i in idx]))
    tg = dev32(np.stack([np.asarray(dataset.gts[i]["cam_t_m2c"],
                                    np.float32).reshape(3) for i in idx]))
    out = np.empty(idx.size, np.float64)
    with torch.no_grad():
        for s in range(0, idx.size, chunk):
            e = err_fn(Re[s:s + chunk], te[s:s + chunk], Rg[s:s + chunk],
                       tg[s:s + chunk], v)
            out[s:s + chunk] = e.cpu().numpy().astype(np.float64)
    errs[idx] = np.where(np.isnan(out), 10000.0, out)
    return errs


def summarize(errors: np.ndarray, diameter: float,
              prefix: str = "ADD") -> Dict[str, float]:
    """Recall@{0.1,0.05,0.02}d + mean + step-AUC + posecnn-AUC
    (test.py:465-532 aggregation)."""
    return {
        f"{prefix}_recall_0.1d": recall_at(errors, diameter, 0.1),
        f"{prefix}_recall_0.05d": recall_at(errors, diameter, 0.05),
        f"{prefix}_recall_0.02d": recall_at(errors, diameter, 0.02),
        f"{prefix}_mean_err": float(np.mean(errors)),
        f"{prefix}_auc_step": float(np.mean(auc_step(errors))),
        f"{prefix}_auc_posecnn": auc_posecnn(errors / 1000.0),
    }


def evaluate_object(dataset: CropDatasetHost, eval_step,
                    vertices: np.ndarray, diameter: float,
                    symmetric: bool, obj_id: int, dataset_name: str,
                    obj_name: str, output_dir: Optional[str] = None,
                    scores: Optional[Sequence[float]] = None,
                    batch_size: int = 16, seed: int = 0,
                    device=None) -> EvalResult:
    """Full single-object evaluation + artifact dump (CSV, add_err.txt,
    ADD_result.txt)."""
    timing: Dict[str, float] = {}
    Rs, ts, ok = run_inference(dataset, eval_step, batch_size, seed=seed,
                               device=device, timing=timing)
    # reference: failed images get identity R / zero t in the CSV
    Rs[~ok] = np.eye(3)
    ts[~ok] = 0
    t0 = time.perf_counter()
    errors = pose_errors(dataset, Rs, ts, ok, vertices, symmetric,
                         device=device)
    metrics = summarize(errors, diameter, "ADD-S" if symmetric else "ADD")
    timing["pose_errors_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        ids = parse_sample_ids(dataset.rgb_files)
        if scores is None:
            scores = [1.0] * len(dataset)
        write_csv(os.path.join(output_dir, "pose_result_bop"),
                  f"{dataset_name}_{obj_name}", obj_id,
                  [s for s, _ in ids], [i for _, i in ids],
                  list(Rs), [t.reshape(3, 1) for t in ts], list(scores))
        with open(os.path.join(output_dir, "add_err.txt"), "w") as f:
            f.write(f"object diameter{diameter}\n")
            for i, (fn, e) in enumerate(zip(dataset.rgb_files, errors)):
                f.write(f"{i}:{e} {fn}\n")
        with open(os.path.join(output_dir, "ADD_result.txt"), "w") as f:
            for k, v in metrics.items():
                f.write(f"{k} {v}\n")
    timing["write_s"] = time.perf_counter() - t0

    return EvalResult(Rs, ts, ok, errors, metrics, timing)
