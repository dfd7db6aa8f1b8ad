"""The training batches' draws as the port's device-cache path makes
them, worked out again: `data/pipeline.py::CachedBatchIterator` draws
the frame indices from default_rng(iterator seed), and each drawn row's
`CropDatasetHost.get_params` jitters its GT bbox with `ops/roi.py::
augment_bbox` under a seed from default_rng(dataset seed), then
`square_bbox` gives the crop square (crop_square_resize)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .roi import augment_bbox, square_bbox


class BatchDraws:
    def __init__(self, bboxes: np.ndarray, batch: int, iterator_seed: int,
                 dataset_seed: int, padding_ratio: float):
        self.bboxes, self.batch = bboxes, batch
        self.padding = padding_ratio
        self.rng = np.random.default_rng(iterator_seed)
        self.ds_rng = np.random.default_rng(dataset_seed)

    def next(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(idx [B] int32, roi_param [B, 5] int32, valid [B] f32)."""
        idx = self.rng.integers(0, len(self.bboxes), size=self.batch)
        rows = []
        for i in idx:
            s = int(self.ds_rng.integers(0, 2 ** 63))
            bbox = augment_bbox(np.asarray(self.bboxes[i]), self.padding,
                                np.random.default_rng(s))
            x1, y1, x2, y2, side = square_bbox(bbox)
            rows.append([x1, y1, x2, y2, max(side, 1)])
        return (idx.astype(np.int32), np.array(rows, np.int32),
                np.ones((self.batch,), np.float32))
