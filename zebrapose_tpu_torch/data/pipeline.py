"""Preprocessing on the device (raw frames -> model batch) and the host
dataset that feeds it.

Port of `zebrapose_tpu/data/pipeline.py`. `preprocess_batch`: crop +
resize (linear for the BGR frame, nearest for GT label and masks), in
training the GDR-Net color augmentation of the f32 crop
(`ops/augment.py`), ImageNet normalization, label RGB -> class id ->
code planes. BGR channel order is kept on purpose: the reference
normalizes cv2's BGR frames with RGB ImageNet statistics, and trained
checkpoints expect exactly that.

`CropDatasetHost` does byte I/O and integer bbox bookkeeping on the
host (evaluation bboxes, or in training GT bboxes jittered per draw),
nothing per-pixel, PNGs decoded by the port's own reader
(`data/png.py`) where the JAX package calls cv2. `MixedBatchIterator`
mixes two training splits with a prefetch thread and a reading pool.
The training input modes beside it: `DeviceDatasetCache` +
`CachedBatchIterator` + `gather_preprocess_batch` (the splits' pixels
uploaded once, batches gathered on the device; `train --input_mode
device_cache`) and `DevicePrefetchIterator` (the next batch copied to
the device on a side stream while the step runs; `--input_mode
prefetch`).
"""

from __future__ import annotations

import bisect
import os
import queue
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from zebrapose_tpu_torch.data import png

from zebrapose_tpu_torch.codec.surface_code import (
    class_id_to_code,
    rgb_to_class_id,
)
from zebrapose_tpu_torch.ops.augment import (
    AugmentDraws,
    augment_batch,
    draw_augment,
)
from zebrapose_tpu_torch.ops.roi import (
    augment_bbox,
    extract_roi_affine,
    extract_roi_clipped,
    extract_roi_square,
    final_bbox,
    padding_bbox,
    square_bbox,
    warp_affine_params,
)

_ROI = {"crop_square_resize": extract_roi_square,
        "crop_resize": extract_roi_clipped,
        "crop_resize_by_warp_affine": extract_roi_affine}


def _roi(imgs, param, crop, method, interpolation):
    if method not in _ROI:
        raise NotImplementedError(method)
    return _ROI[method](imgs, param, crop, interpolation)


def preprocess_batch(raw: Dict[str, torch.Tensor], crop_img: int = 256,
                     crop_gt: int = 128, base: int = 2, n_bits: int = 16,
                     resize_method: str = "crop_square_resize",
                     include_gt: bool = True, is_train: bool = False,
                     use_pepper_salt: bool = False,
                     use_motion_blur: bool = False,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[AugmentDraws] = None
                     ) -> Dict[str, torch.Tensor]:
    """raw: {"rgb" [N,H,W,3] u8 BGR, "label" [N,H,W,3] u8, "mask"
    [N,H,W] u8, "entire_mask" [N,H,W] u8, "roi_param" ([N,5] int square
    | [N,4] int clipped | [N,3] f32 affine), "valid" [N] f32}, tensors
    on one device.

    Returns {"image" [N,crop_img,crop_img,3]} and, with include_gt, also
    "mask", "entire_mask" [N,crop_gt,crop_gt] and "code"
    [N,crop_gt,crop_gt,n_bits]. The u8 pixels are gathered as they are
    and widened by the interpolation weights (same values as widening
    first). is_train augments the f32 crop before normalization with
    `draws`, or with values drawn from `generator` (a torch.Generator
    on the batch's device).
    """
    # imported here: a serving process imports this module, not the model
    from zebrapose_tpu_torch.models.zebra_net import normalize_image

    p = raw["roi_param"]
    roi_rgb = _roi(raw["rgb"], p, crop_img, resize_method, "linear")
    if is_train:
        if draws is None:
            if generator is None:
                raise ValueError("a training batch needs a generator or "
                                 "injected draws")
            draws = draw_augment(generator, roi_rgb.shape[0], crop_img,
                                 crop_img, use_pepper_salt, use_motion_blur)
        roi_rgb = augment_batch(roi_rgb, draws)
    image = normalize_image(roi_rgb / 255.0)
    valid = raw["valid"].to(torch.float32)[:, None, None]
    if not include_gt:
        return {"image": image * valid[..., None]}

    roi_label = _roi(raw["label"], p, crop_gt, resize_method, "nearest")
    ids = rgb_to_class_id(torch.round(roi_label).to(torch.int32))
    code = class_id_to_code(ids, base=base, n_digits=n_bits)

    def _mask_roi(m):
        r = _roi(m[..., None], p, crop_gt, resize_method, "nearest")
        return r[..., 0] / 255.0

    return {
        "image": image * valid[..., None],
        "mask": _mask_roi(raw["mask"]) * valid,
        "entire_mask": _mask_roi(raw["entire_mask"]) * valid,
        "code": code * valid[..., None],
    }


# ---------------------------------------------------------------------------
# Host dataset
# ---------------------------------------------------------------------------

class CropDatasetHost:
    """Host-side sample provider for one object.

    Port of `zebrapose_tpu/data/pipeline.py::CropDatasetHost`: raw
    full-resolution arrays + bbox params per sample (the crop happens on
    the device), the same keys, dtypes and bytes. In training
    (`is_train`) each draw jitters the GT bbox (`augment_bbox`) with a
    per-sample seed taken from `default_rng(seed)` under a lock, as in
    JAX. `gt_dir_suffix` selects `<split>_GT` (v1 labels) vs
    `<split>_GT_v2`.
    """

    def __init__(self, dataset_dir: str, data_folder: str,
                 rgb_files: Sequence[str],
                 mask_files: Sequence[Sequence[str]],
                 mask_visib_files: Sequence[Sequence[str]],
                 gts: Sequence[Optional[dict]],
                 gt_infos: Sequence[Optional[dict]],
                 cam_params: Sequence[dict],
                 is_train: bool = False,
                 crop_size_img: int = 256, crop_size_gt: int = 128,
                 padding_ratio: float = 1.5,
                 resize_method: str = "crop_square_resize",
                 gt_dir_suffix: str = "_GT_v2",
                 detect_bboxes: Optional[Sequence] = None,
                 detect_segmentations: Optional[Sequence] = None,
                 seed: int = 0,
                 cache_images: bool = False,
                 roi_slice: bool = False):
        self.dataset_dir = dataset_dir
        self.data_folder = data_folder
        self.rgb_files = list(rgb_files)
        self.mask_files = list(mask_files)
        self.mask_visib_files = list(mask_visib_files)
        self.gts = list(gts)
        self.gt_infos = list(gt_infos)
        self.cam_params = list(cam_params)
        self.is_train = is_train
        self.crop_size_img = crop_size_img
        self.crop_size_gt = crop_size_gt
        self.padding_ratio = padding_ratio
        self.resize_method = resize_method
        self.gt_dir_suffix = gt_dir_suffix
        self.detect_bboxes = detect_bboxes
        self.detect_segmentations = detect_segmentations
        self.rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()
        # opt-in decoded-image RAM cache (~2.4 MB per 480x640 sample)
        self._cache: Optional[dict] = {} if cache_images else None
        self._cache_lock = threading.Lock()
        # opt-in: ship only each frame's clamped square-bbox bytes (see
        # _slice_roi)
        if roi_slice and is_train:
            raise ValueError("roi_slice is a serving mode "
                             "(is_train=False only)")
        if roi_slice and resize_method != "crop_square_resize":
            raise NotImplementedError(
                "roi_slice supports crop_square_resize only")
        self.roi_slice = roi_slice
        self._slice_hw: Optional[tuple] = None
        self._forced_slice_hw: Optional[tuple] = None

    def __len__(self):
        return len(self.rgb_files)

    def _imread(self, path: str, flags: int = png.IMREAD_COLOR):
        if self._cache is None:
            return png.imread(path, flags)
        key = (path, flags)
        with self._cache_lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        img = png.imread(path, flags)
        if img is not None:
            with self._cache_lock:
                self._cache[key] = img
        return img

    def _gt_label_path(self, idx: int) -> str:
        scene_id = self.rgb_files[idx].split("/")[-3]
        name = os.path.basename(self.mask_visib_files[idx][0])
        return os.path.join(self.dataset_dir,
                            self.data_folder + self.gt_dir_suffix,
                            scene_id, name)

    def _roi_param(self, bbox, im_shape):
        """Integer/float bbox bookkeeping -> device roi param + final
        bbox."""
        h, w = im_shape[:2]
        if self.resize_method == "crop_square_resize":
            x1, y1, x2, y2, side = square_bbox(bbox)
            param = np.array([x1, y1, x2, y2, max(side, 1)], np.int32)
        elif self.resize_method == "crop_resize":
            fb = final_bbox(bbox, "crop_resize", w, h)
            param = np.array([fb[0], fb[1], max(fb[2], 1),
                              max(fb[3], 1)], np.int32)
        else:  # crop_resize_by_warp_affine
            cx, cy, scale = warp_affine_params(bbox, (h, w))
            param = np.array([cx, cy, max(scale, 1e-3)], np.float32)
        fb = final_bbox(bbox, self.resize_method, w, h)
        return param, fb.astype(np.int64)

    def get_pixels(self, idx: int) -> Dict[str, np.ndarray]:
        """Per-sample pixel data: rgb, GT label, visible and entire
        masks."""
        rgb = self._imread(self.rgb_files[idx])
        if rgb is None:
            raise FileNotFoundError(self.rgb_files[idx])
        h, w = rgb.shape[:2]

        def _read_mask(path):
            m = self._imread(path, png.IMREAD_GRAYSCALE) \
                if path and os.path.exists(path) else None
            return m if m is not None else np.zeros((h, w), np.uint8)

        mask = _read_mask(self.mask_visib_files[idx][0])
        if (not self.is_train and self.detect_segmentations is not None
                and self.detect_segmentations[idx] is not None):
            # Mask-RCNN variant: the detector's RLE replaces the visible
            # mask (bop_dataset_pytorch_mask_rcnn.py:270-287)
            from zebrapose_tpu_torch.data.detections import decode_rle
            mask = decode_rle(self.detect_segmentations[idx]) * 255
        entire = _read_mask(self.mask_files[idx][0])
        gt_path = self._gt_label_path(idx)
        # GT-less entries (vivo/challenge) have empty mask names, which
        # give a directory path here
        label = self._imread(gt_path) \
            if gt_path and os.path.isfile(gt_path) else None
        if label is None:
            label = np.zeros((h, w, 3), np.uint8)
        return {"rgb": rgb, "label": label, "mask": mask,
                "entire_mask": entire}

    def _eval_bbox(self, idx: int):
        """Deterministic test-time bbox (detection or GT) + padding, and
        the sample's validity (0 without a detection)."""
        valid = 1.0
        if self.detect_bboxes is not None:
            det = self.detect_bboxes[idx]
            if det is None:
                det = np.array([0, 0, 1, 1])
                valid = 0.0
            bbox = np.asarray(det)
        else:
            bbox = np.asarray(self.gt_infos[idx]["bbox_visib"])
        if np.all(np.isclose(bbox, -1)):
            bbox = np.array([0, 0, 1, 1])
            valid = 0.0
        return padding_bbox(bbox, self.padding_ratio), valid

    def get_params(self, idx: int,
                   im_shape: tuple) -> Dict[str, np.ndarray]:
        """Pose/K plus the bbox (in training freshly jittered) -> roi
        param + final bbox. No pixel access."""
        gt = self.gts[idx]
        if gt is not None:
            R = np.asarray(gt["cam_R_m2c"], np.float64).reshape(3, 3)
            t = np.asarray(gt["cam_t_m2c"], np.float64).reshape(3)
        else:
            R = np.eye(3)
            t = np.zeros(3)
        K = np.asarray(self.cam_params[idx]["cam_K"],
                       np.float64).reshape(3, 3)
        if self.is_train:
            valid = 1.0
            # a seed per sample: get_raw runs on a thread pool and numpy
            # Generators are not thread-safe
            with self._rng_lock:
                sample_seed = int(self.rng.integers(0, 2 ** 63))
            bbox = augment_bbox(np.asarray(self.gt_infos[idx]["bbox_visib"]),
                                self.padding_ratio,
                                np.random.default_rng(sample_seed))
        else:
            bbox, valid = self._eval_bbox(idx)
        param, fb = self._roi_param(bbox, im_shape)
        return {"roi_param": param, "final_bbox": fb,
                "R": R.astype(np.float32), "t": t.astype(np.float32),
                "K": K.astype(np.float32), "valid": np.float32(valid)}

    def _slice_buffer_hw(self, im_h: int, im_w: int):
        """Dataset-wide buffer dims for roi_slice: the max padded square
        side over every sample's eval bbox, rounded up to a multiple of
        16 and capped at the frame dims (one shape per run), or the size
        `set_slice_hw` imposed when it covers that. Frames of differing
        sizes within one dataset are rejected."""
        if self._slice_hw is not None:
            hw, cap = self._slice_hw
            if cap != (im_h, im_w):
                raise ValueError(
                    f"roi_slice: mixed frame sizes in one dataset "
                    f"({cap} vs {(im_h, im_w)})")
            return hw
        max_side = 1
        for i in range(len(self)):
            bbox, _ = self._eval_bbox(i)
            max_side = max(max_side, int(square_bbox(bbox)[4]))
        side = -(-max_side // 16) * 16
        hw = (min(side, im_h), min(side, im_w))
        if self._forced_slice_hw is not None:
            fh, fw = self._forced_slice_hw
            if fh < hw[0] or fw < hw[1]:
                raise ValueError(
                    f"forced roi_slice buffer {self._forced_slice_hw} is "
                    f"smaller than this dataset needs ({hw}) — real "
                    f"pixels would be dropped")
            hw = (min(fh, im_h), min(fw, im_w))
        self._slice_hw = (hw, (im_h, im_w))
        return hw

    def natural_slice_hw(self) -> tuple:
        """The buffer dims this dataset would use on its own (reads one
        frame for the cap). The fleet takes the elementwise max over its
        K objects' naturals and imposes it with set_slice_hw, so the
        stacked lockstep batches share one shape."""
        img = self._imread(self.rgb_files[0])
        saved, self._slice_hw = self._slice_hw, None
        forced, self._forced_slice_hw = self._forced_slice_hw, None
        try:
            return self._slice_buffer_hw(img.shape[0], img.shape[1])
        finally:
            self._slice_hw, self._forced_slice_hw = saved, forced

    def set_slice_hw(self, hw: tuple) -> None:
        """Impose a shared roi_slice buffer size (the fleet's max). It
        must cover this dataset's own natural size, which is checked on
        first use."""
        self._forced_slice_hw = (int(hw[0]), int(hw[1]))
        self._slice_hw = None

    def _slice_roi(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Byte-slice the clamped square-bbox region of every pixel array
        into the zero-padded dataset buffer and shift roi_param by the
        slice origin. The device crop is bit-identical to the full-frame
        one: real pixels keep their tap coordinates relative to the
        shifted param, and every tap outside the slice reads zeros or is
        killed by the validity gate, as outside the frame."""
        im_h, im_w = out["rgb"].shape[:2]
        bh, bw = self._slice_buffer_hw(im_h, im_w)
        p = out["roi_param"]
        x1, y1, x2, y2 = int(p[0]), int(p[1]), int(p[2]), int(p[3])
        xs, ys = max(x1, 0), max(y1, 0)
        xe, ye = max(min(x2, im_w), xs), max(min(y2, im_h), ys)
        # a square larger than the frame: copy what fits the buffer (the
        # rest reads as zero, as the full-frame validity gate gives)
        ye, xe = min(ye, ys + bh), min(xe, xs + bw)
        for k in ("rgb", "label", "mask", "entire_mask"):
            buf = np.zeros((bh, bw) + out[k].shape[2:], out[k].dtype)
            buf[:ye - ys, :xe - xs] = out[k][ys:ye, xs:xe]
            out[k] = buf
        out["roi_param"] = p - np.array([xs, ys, xs, ys, 0], p.dtype)
        return out

    def get_raw(self, idx: int) -> Dict[str, np.ndarray]:
        px = self.get_pixels(idx)
        out = dict(px)
        out.update(self.get_params(idx, px["rgb"].shape))
        if self.roi_slice:
            out = self._slice_roi(out)
        return out

    def collate(self, indices: Sequence[int],
                executor=None) -> Dict[str, np.ndarray]:
        """Stack the samples' raw dicts; `executor` (a thread pool) reads
        them in parallel."""
        if executor is not None:
            rows = list(executor.map(self.get_raw, indices))
        else:
            rows = [self.get_raw(i) for i in indices]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


class MixedBatchIterator:
    """Endless training batches mixing two splits (the reference
    concatenates a batch of each of its two DataLoaders every step,
    train_v2.py:228-244): `second_dataset_ratio` of each batch from ds2
    when it has samples. A prefetch thread collates `prefetch` batches
    ahead; samples are read on a pool of `num_workers` threads (PNG
    decode releases the interpreter lock in zlib; 0 = in the prefetch
    thread). Indices come from `default_rng(seed)`, as in JAX."""

    def __init__(self, ds1: CropDatasetHost,
                 ds2: Optional[CropDatasetHost],
                 batch_size: int, second_dataset_ratio: float = 0.75,
                 seed: int = 0, prefetch: int = 2, num_workers: int = 8):
        from concurrent.futures import ThreadPoolExecutor

        self.ds1, self.ds2 = ds1, ds2
        if ds2 is not None and len(ds2) > 0:
            self.n2 = int(batch_size * second_dataset_ratio)
        else:
            self.n2 = 0
            self.ds2 = None
        self.n1 = batch_size - self.n2
        self.rng = np.random.default_rng(seed)
        self._pool = ThreadPoolExecutor(max_workers=num_workers) \
            if num_workers > 0 else None
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _draw(self, ds, n):
        return self.rng.integers(0, len(ds), size=n)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def _worker(self):
        try:
            while not self._stop.is_set():
                b1 = self.ds1.collate(self._draw(self.ds1, self.n1),
                                      executor=self._pool)
                if self.ds2 is not None:
                    b2 = self.ds2.collate(self._draw(self.ds2, self.n2),
                                          executor=self._pool)
                    b1 = {k: np.concatenate([b1[k], b2[k]]) for k in b1}
                self._put(b1)
        except BaseException as e:  # handed to the consumer, re-raised
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        """Stop the prefetch thread before the pool shuts down (the other
        order makes an in-flight collate raise in the thread)."""
        self._stop.set()
        try:  # unblock a producer stuck on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# Device-resident training input
# ---------------------------------------------------------------------------

FEED_KEYS = ("rgb", "label", "mask", "entire_mask", "roi_param", "valid")


class DeviceDatasetCache:
    """The full-resolution pixels of one or more (concatenated)
    CropDatasetHosts, uploaded to device memory once as uint8; a step
    then sends only int indices and roi params and gathers its batch on
    the device (`gather_preprocess_batch`). Port of JAX
    `pipeline.py::DeviceDatasetCache`: JAX replicates the cache over its
    mesh; in a data-parallel world each rank holds the whole split on
    its own card, and its `CachedBatchIterator` draws its rows.

    Costs ~2.46 MB of device memory a 480x640 sample (rgb + label + two
    masks): for per-object real splits, not 50k-image PBR trees (the
    streaming `MixedBatchIterator` stays the default). Raises on mixed
    image sizes. `nbytes` is the upload's size."""

    PIXEL_KEYS = ("rgb", "label", "mask", "entire_mask")

    def __init__(self, datasets: Sequence[CropDatasetHost], device):
        self.datasets = [d for d in datasets if d is not None]
        if not self.datasets:
            raise ValueError("need at least one dataset")
        self.offsets = [0]
        for ds in self.datasets:
            self.offsets.append(self.offsets[-1] + len(ds))
        host: Dict[str, np.ndarray] = {}
        hw = None
        row = 0
        for ds in self.datasets:
            for i in range(len(ds)):
                px = ds.get_pixels(i)
                if hw is None:
                    hw = px["rgb"].shape[:2]
                    host = {k: np.empty((self.offsets[-1],) + px[k].shape,
                                        px[k].dtype)
                            for k in self.PIXEL_KEYS}
                elif px["rgb"].shape[:2] != hw:
                    raise ValueError(
                        f"mixed image sizes {hw} vs {px['rgb'].shape[:2]}"
                        " -- the device cache needs one image geometry")
                for k in self.PIXEL_KEYS:
                    host[k][row] = px[k]
                row += 1
        self.image_hw = hw
        self.arrays = {k: torch.from_numpy(v).to(device)
                       for k, v in host.items()}
        self.nbytes = sum(v.nbytes for v in host.values())

    def __len__(self):
        return self.offsets[-1]

    def params(self, flat_indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Host-side per-draw bookkeeping (roi param, final bbox, pose,
        K, valid) for concatenated indices."""
        rows = []
        for fi in flat_indices:
            k = bisect.bisect_right(self.offsets, int(fi)) - 1
            rows.append(self.datasets[k].get_params(
                int(fi) - self.offsets[k], self.image_hw))
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


class CachedBatchIterator:
    """Mixed real + PBR batch draws against a DeviceDatasetCache: only
    indices and roi params (the split of `MixedBatchIterator`, no worker
    threads: there are no bytes to read). Indices come from
    `default_rng(seed)` in JAX's order, so `idx` equals JAX's at the
    same seed; in a data-parallel world each rank draws its share of
    the global batch with seed = its rank, as JAX's process does with
    seed = jax.process_index()."""

    def __init__(self, cache: DeviceDatasetCache, batch_size: int,
                 second_dataset_ratio: float = 0.75, seed: int = 0):
        self.cache = cache
        if len(cache.datasets) > 1 and len(cache.datasets[1]) > 0:
            self.n2 = int(batch_size * second_dataset_ratio)
        else:
            self.n2 = 0
        self.n1 = batch_size - self.n2
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        o = self.cache.offsets
        idx = self.rng.integers(0, o[1], size=self.n1)
        if self.n2:
            idx = np.concatenate([idx, self.rng.integers(o[1], o[2],
                                                         size=self.n2)])
        p = self.cache.params(idx)
        return {"idx": idx.astype(np.int32), "roi_param": p["roi_param"],
                "valid": p["valid"]}

    def close(self):
        pass


class DevicePrefetchIterator:
    """Wrap a host batch iterator so that each feed reaches the device one
    step ahead: a worker thread takes the next feed, pins its arrays and
    copies them with non_blocking=True on a side CUDA stream, recording
    an event after the copies, so the copy of batch k+1 overlaps step k.
    The consumer's `__next__` makes the current stream wait on that
    event and calls `record_stream` on every tensor it hands out, so the
    caching allocator does not give their memory to a later copy while
    the step still reads them. Port of JAX
    `pipeline.py::DevicePrefetchIterator` (`shard_batch` one step ahead)
    on this rank's device.

    The worker sets the device in its own thread; its exception is
    raised from `__next__`; `close()` stops it and closes the inner
    iterator. On the CPU it is the same queue with no stream. Feeds are
    dicts of tensors on `device` (`device_resident` marks this): in a
    data-parallel world, the rank's card (JAX shards the feed over its
    mesh)."""

    device_resident = True

    def __init__(self, inner, device, keys: Sequence[str] = FEED_KEYS,
                 depth: int = 2):
        self.inner = inner
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the worker thread sets it: an index, not the current one
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, args=(keys,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, keys):
        try:
            cuda = self.device.type == "cuda"
            if cuda:
                torch.cuda.set_device(self.device)
                side = torch.cuda.Stream(self.device)
            while not self._stop.is_set():
                raw = next(self.inner)
                if not cuda:
                    feed = {k: torch.as_tensor(np.asarray(raw[k]))
                            for k in keys}
                    if not self._put((feed, None)):
                        return
                    continue
                pinned = {k: torch.from_numpy(
                    np.ascontiguousarray(raw[k])).pin_memory() for k in keys}
                with torch.cuda.stream(side):
                    feed = {k: v.to(self.device, non_blocking=True)
                            for k, v in pinned.items()}
                    done = torch.cuda.Event()
                    done.record(side)
                if not self._put((feed, done)):
                    return
        except BaseException as e:  # handed to the consumer, re-raised
            self._put((e, None))

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        feed, done = self._q.get()
        if isinstance(feed, BaseException):
            raise feed
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for v in feed.values():
                v.record_stream(stream)
        return feed

    def close(self):
        self._stop.set()
        try:  # unblock a worker stuck on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        if hasattr(self.inner, "close"):
            self.inner.close()


def gather_preprocess_batch(cache_arrays: Dict[str, torch.Tensor],
                            idx: torch.Tensor, roi_param: torch.Tensor,
                            valid: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            crop_img: int = 256, crop_gt: int = 128,
                            base: int = 2, n_bits: int = 16,
                            resize_method: str = "crop_square_resize",
                            use_pepper_salt: bool = False,
                            use_motion_blur: bool = False,
                            draws: Optional[AugmentDraws] = None
                            ) -> Dict[str, torch.Tensor]:
    """A training batch from a DeviceDatasetCache's arrays: the drawn
    samples gathered on the device (`index_select`, still uint8), then
    `preprocess_batch(is_train=True)` with `generator` (or `draws`).
    `idx`, `roi_param` and `valid` are moved to the arrays' device."""
    dev = cache_arrays["rgb"].device
    idx = torch.as_tensor(idx).to(dev, torch.int64)
    raw = {k: torch.index_select(cache_arrays[k], 0, idx)
           for k in DeviceDatasetCache.PIXEL_KEYS}
    raw["roi_param"] = torch.as_tensor(roi_param).to(dev)
    raw["valid"] = torch.as_tensor(valid).to(dev)
    return preprocess_batch(
        raw, crop_img=crop_img, crop_gt=crop_gt, base=base, n_bits=n_bits,
        resize_method=resize_method, is_train=True,
        use_pepper_salt=use_pepper_salt, use_motion_blur=use_motion_blur,
        generator=generator, draws=draws)
