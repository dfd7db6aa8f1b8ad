"""The port's training input modes on the CPU: `DeviceDatasetCache`,
`CachedBatchIterator`, `gather_preprocess_batch`,
`DevicePrefetchIterator`, and `train --input_mode prefetch |
device_cache` against `stream`.

The tree is tests/test_torch_trainer.py's (LM-O layout, 96x128 frames,
`train_real` of 5 frames and `train_second` of 4; 32² crops).

Tolerances and why: exact everywhere. The cache holds the frames' bytes;
its draws are JAX's (the same numpy generator in the same order, the
same per-sample jitter seeds); a gathered batch and a streamed one are
the same pixels through the same preprocess with the same generator;
the prefetch iterator hands out the inner feeds unchanged; and two
training steps from the same init on the same draws are the same
arithmetic in every mode, so the checkpoints are bit-equal.
"""

import json
import shutil
import threading

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_trainer import (  # noqa: F401  (fixtures)
    H,
    W,
    _datasets,
    _hide_module_stubs,
    _write_cfg,
    tree,
)
from zebrapose_tpu.data import pipeline as jpipe
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.data.pipeline import (
    FEED_KEYS,
    CachedBatchIterator,
    DeviceDatasetCache,
    DevicePrefetchIterator,
    MixedBatchIterator,
    gather_preprocess_batch,
    preprocess_batch,
)

KW = dict(crop_img=32, crop_gt=16, base=2, n_bits=16,
          resize_method="crop_square_resize")

@pytest.fixture(autouse=True)
def _delete_tmp(tmp_path):
    """Checkpoints here are 0.1-0.35 GB each: a test's files go when it
    ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)



def _pair(tree, seed=0):
    """(JAX, port) datasets of both training splits."""
    (j1, t1), (j2, t2) = (_datasets(tree[0], seed=seed),
                          _datasets(tree[0], "train_second", seed=seed))
    return (j1, j2), (t1, t2)


def test_device_dataset_cache_holds_the_pixels(tree, monkeypatch):
    _, (t1, t2) = _pair(tree)
    cache = DeviceDatasetCache([t1, None, t2], torch.device("cpu"))
    assert cache.offsets == [0, 5, 9] and len(cache) == 9
    assert cache.image_hw == (H, W)
    for k, shape in (("rgb", (9, H, W, 3)), ("label", (9, H, W, 3)),
                     ("mask", (9, H, W)), ("entire_mask", (9, H, W))):
        assert cache.arrays[k].dtype == torch.uint8
        assert tuple(cache.arrays[k].shape) == shape
    for flat, (ds, i) in ((0, (t1, 0)), (4, (t1, 4)), (5, (t2, 0)),
                          (8, (t2, 3))):
        px = ds.get_pixels(i)
        for k in cache.PIXEL_KEYS:
            np.testing.assert_array_equal(cache.arrays[k][flat].numpy(),
                                          px[k])
    assert cache.nbytes == 9 * H * W * (3 + 3 + 1 + 1)
    # the bisect lookup: a draw's bookkeeping from its own dataset
    _, (f1, f2) = _pair(tree, seed=4)
    p = DeviceDatasetCache([f1, f2], "cpu").params([6, 1])
    _, (g1, g2) = _pair(tree, seed=4)
    want = [g2.get_params(1, (H, W)), g1.get_params(1, (H, W))]
    for k in p:
        np.testing.assert_array_equal(p[k], np.stack([w[k] for w in want]))
    with pytest.raises(ValueError, match="at least one"):
        DeviceDatasetCache([None], "cpu")
    small = t2.get_pixels(0)
    monkeypatch.setattr(t2, "get_pixels", lambda i: {
        k: v[:-1] for k, v in small.items()})
    with pytest.raises(ValueError, match="mixed image sizes"):
        DeviceDatasetCache([t1, t2], "cpu")


@pytest.mark.parametrize("ratio", [0.5, 0.75])
def test_cached_batch_iterator_draws_as_jax(tree, ratio):
    """idx (and with it roi_param and valid) equal to JAX's
    CachedBatchIterator at the same seed, over several draws."""
    (j1, j2), (t1, t2) = _pair(tree)
    jit = jpipe.CachedBatchIterator(jpipe.DeviceDatasetCache([j1, j2]),
                                    batch_size=6,
                                    second_dataset_ratio=ratio, seed=7)
    tit = CachedBatchIterator(DeviceDatasetCache([t1, t2], "cpu"),
                              batch_size=6, second_dataset_ratio=ratio,
                              seed=7)
    assert (tit.n1, tit.n2) == (jit.n1, jit.n2)
    for _ in range(4):
        got, want = next(tit), next(jit)
        assert sorted(got) == sorted(want) == ["idx", "roi_param", "valid"]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    one = CachedBatchIterator(DeviceDatasetCache([t1], "cpu"), 4, seed=7)
    assert (one.n1, one.n2) == (4, 0)
    assert next(one)["idx"].max() < 5


def test_gather_preprocess_batch_equals_the_streamed_batch(tree):
    """The same draws through the cache and through collate: the same
    training batch, with the same augmentation generator."""
    _, (t1, t2) = _pair(tree, seed=2)
    cache = DeviceDatasetCache([t1, t2], "cpu")
    feed = CachedBatchIterator(cache, 6, second_dataset_ratio=0.5,
                               seed=1)
    draw = next(feed)
    got = gather_preprocess_batch(
        cache.arrays, draw["idx"], draw["roi_param"], draw["valid"],
        torch.Generator().manual_seed(3), **KW)
    _, (s1, s2) = _pair(tree, seed=2)
    stream = MixedBatchIterator(s1, s2, batch_size=6,
                                second_dataset_ratio=0.5, seed=1,
                                num_workers=0)
    try:
        raw = next(stream)
    finally:
        stream.close()
    np.testing.assert_array_equal(raw["roi_param"], draw["roi_param"])
    want = preprocess_batch(
        {k: torch.as_tensor(raw[k]) for k in (
            "rgb", "label", "mask", "entire_mask", "roi_param", "valid")},
        is_train=True, generator=torch.Generator().manual_seed(3), **KW)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


class _Feeds:
    """An inner iterator of numbered feeds that can fail at the n-th."""

    def __init__(self, fail_at=None):
        self.i, self.fail_at, self.closed = 0, fail_at, False

    def __next__(self):
        if self.i == self.fail_at:
            raise FileNotFoundError("frame 7")
        self.i += 1
        return {"rgb": np.full((2, 4, 4, 3), self.i, np.uint8),
                "roi_param": np.array([[self.i] * 5] * 2, np.int32)}

    def close(self):
        self.closed = True


def test_device_prefetch_iterator_hands_out_the_inner_feeds(tree):
    it = DevicePrefetchIterator(_Feeds(), "cpu", keys=("rgb", "roi_param"))
    try:
        assert it.device_resident
        for i in range(1, 5):
            feed = next(it)
            assert sorted(feed) == ["rgb", "roi_param"]
            assert isinstance(feed["rgb"], torch.Tensor)
            assert feed["rgb"].dtype == torch.uint8
            assert int(feed["rgb"][0, 0, 0, 0]) == i
            assert feed["roi_param"].tolist() == [[i] * 5] * 2
    finally:
        it.close()
    assert it.inner.closed and not it._thread.is_alive()
    # a real MixedBatchIterator inside: its batches, and close() stops its
    # reading thread too
    _, (a1, _) = _pair(tree)
    _, (b1, _) = _pair(tree)
    inner = MixedBatchIterator(a1, None, batch_size=3, seed=2,
                               num_workers=0)
    twin = MixedBatchIterator(b1, None, batch_size=3, seed=2,
                              num_workers=0)
    it = DevicePrefetchIterator(inner, "cpu")
    try:
        for _ in range(3):
            got, want = next(it), next(twin)
            for k in FEED_KEYS:
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    finally:
        it.close()
        twin.close()
    assert not inner._thread.is_alive() and not it._thread.is_alive()


def test_device_prefetch_iterator_raises_the_workers_error():
    before = threading.active_count()
    it = DevicePrefetchIterator(_Feeds(fail_at=2), "cpu",
                                keys=("rgb",))
    try:
        next(it)
        next(it)
        with pytest.raises(FileNotFoundError, match="frame 7"):
            next(it)
    finally:
        it.close()
    assert threading.active_count() == before


def _train(tree, tmp_path, mode):
    cfg = _write_cfg(tree, tmp_path / f"cfg_{mode}.txt",
                     training_data_folder_2="train_second",
                     second_dataset_ratio=0.5)
    out = tmp_path / mode
    assert cli.main(["train", "--cfg", cfg, "--obj_name", "ape",
                     "--device", "cpu", "--from_scratch", "--max_steps", "2",
                     "--log_freq", "2", "--val_mode", "loss",
                     "--input_mode", mode, "--output_dir", str(out)]) == 0
    run = out / "lmo_ape"
    rows = [json.loads(ln) for ln in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in rows if r["tag"] == "train/step_loss_total"]
    ckpt = torch.load(run / "checkpoints" / "steps" / "step_2.pth",
                      map_location="cpu", weights_only=True)
    return losses, ckpt


def test_train_command_input_modes_equal_stream(tree, tmp_path):
    """Two CPU steps of `train --input_mode prefetch` and `device_cache`
    from the same init over two mixed splits: each step's loss and the
    checkpoint (weights, BN statistics, Adam, histogram) equal to
    `stream`'s, whose draws they share."""
    want_losses, want = _train(tree, tmp_path, "stream")
    assert len(want_losses) == 2
    for mode in ("prefetch", "device_cache"):
        losses, got = _train(tree, tmp_path, mode)
        assert [r["value"] for r in losses] == \
            [r["value"] for r in want_losses], mode
        for part in ("model_state_dict", "histogram"):
            a, b = got[part], want[part]
            if isinstance(a, dict):
                for k in b:
                    assert torch.equal(a[k], b[k]), (mode, k)
            else:
                assert torch.equal(a, b), mode
        sa = got["optimizer_state_dict"]["state"]
        sb = want["optimizer_state_dict"]["state"]
        for i in sb:
            for k in sb[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (mode, i, k)
