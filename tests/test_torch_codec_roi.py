"""Port parity on the CPU: surface codec, correspondence LUT, host bbox
math, device crops and inference preprocessing of `zebrapose_tpu_torch`
against the JAX package.

Codec, LUT, bbox math and pixel mapping must agree exactly. Crops are
a direct gather in the port and interpolation-matrix matmuls in JAX:
within 1e-3 at u8 scale (a few f32 ulps of a 255-scale value).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zebrapose_tpu.codec import lut as jlut
from zebrapose_tpu.codec import surface_code as jsc
from zebrapose_tpu.data.pipeline import preprocess_batch as j_preprocess
from zebrapose_tpu.ops import roi as jroi
from zebrapose_tpu_torch.codec import lut as tlut
from zebrapose_tpu_torch.codec import surface_code as tsc
from zebrapose_tpu_torch.data.pipeline import preprocess_batch
from zebrapose_tpu_torch.ops import roi as troi

# the border cases of tests/test_roi.py::test_square_roi_matches_cv2
BBOXES = [
    (100, 60, 80, 120),     # fully inside, tall
    (-20, -10, 90, 70),     # crosses top-left corner
    (500, 300, 200, 150),   # crosses bottom-right (img 640x480)
    (30, 40, 64, 64),       # already square
]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("base,n_digits", [(2, 16), (4, 8), (16, 7)])
def test_surface_code_exact(base, n_digits):
    rng = np.random.default_rng(1)
    n_id = base ** n_digits
    ids = rng.integers(0, min(n_id, 2 ** 24), (4, 8, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        tsc.class_id_to_rgb(_t(ids)).numpy(),
        np.asarray(jsc.class_id_to_rgb(jnp.asarray(ids))))
    rgb = np.asarray(jsc.class_id_to_rgb(jnp.asarray(ids)))
    np.testing.assert_array_equal(
        tsc.rgb_to_class_id(_t(rgb)).numpy(),
        np.asarray(jsc.rgb_to_class_id(jnp.asarray(rgb))))
    code = tsc.class_id_to_code(_t(ids), base=base, n_digits=n_digits)
    np.testing.assert_array_equal(
        code.numpy(), np.asarray(jsc.class_id_to_code(
            jnp.asarray(ids), base=base, n_digits=n_digits)))
    back = tsc.code_to_class_id(code, base=base)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jsc.code_to_class_id(
            jnp.asarray(code.numpy()), base=base)))
    np.testing.assert_array_equal(back.numpy(), ids)
    with pytest.raises(ValueError):
        tsc.class_id_to_code(_t(ids), base=3)


def test_lut_load_and_reduce_exact(tmp_path):
    rng = np.random.default_rng(2)
    n = 64
    pts = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.2
    path = str(tmp_path / "Class_CorresPoint000001.txt")
    jlut.save_correspondence_lut(path, jlut.CorrespondenceLUT(
        np.where(valid[:, None], pts, 0).astype(np.float32), valid, 2, 6))
    got = tlut.load_correspondence_lut(path)
    want = jlut.load_correspondence_lut(path)
    for a, b in ((got.points, want.points), (got.valid, want.valid)):
        np.testing.assert_array_equal(a, b)
    assert (got.base, got.n_digits) == (want.base, want.n_digits)
    for bits in (0, 1, 2):
        r_got = tlut.reduce_lut_ignore_bits(got, bits)
        r_want = jlut.reduce_lut_ignore_bits(want, bits)
        np.testing.assert_array_equal(r_got.points, r_want.points)
        np.testing.assert_array_equal(r_got.valid, r_want.valid)
        assert r_got.n_digits == r_want.n_digits


def test_host_bbox_math_exact():
    methods = ("crop_square_resize", "crop_resize",
               "crop_resize_by_warp_affine")
    for bb in BBOXES + [(10, 20, 33, 47), (-10, 5, 30, 50)]:
        bb = np.array(bb)
        np.testing.assert_array_equal(troi.padding_bbox(bb, 1.5),
                                      jroi.padding_bbox(bb, 1.5))
        assert troi.square_bbox(bb) == jroi.square_bbox(bb)
        for m in methods:
            np.testing.assert_array_equal(
                troi.final_bbox(bb, m, 640, 480),
                jroi.final_bbox(bb, m, 640, 480))
        assert troi.warp_affine_params(bb, (480, 640)) == \
            jroi.warp_affine_params(bb, (480, 640))
        np.testing.assert_array_equal(
            troi.augment_bbox(bb, 1.5, np.random.default_rng(3)),
            jroi.augment_bbox(bb, 1.5, np.random.default_rng(3)))


def _roi_params(method):
    """Per-bbox device params, as CropDatasetHost._roi_param builds them."""
    out = []
    for bb in BBOXES:
        bb = np.array(bb)
        if method == "crop_square_resize":
            x1, y1, x2, y2, side = jroi.square_bbox(bb)
            out.append(np.array([x1, y1, x2, y2, max(side, 1)], np.int32))
        elif method == "crop_resize":
            fb = jroi.final_bbox(bb, "crop_resize", 640, 480)
            out.append(np.array([fb[0], fb[1], max(fb[2], 1),
                                 max(fb[3], 1)], np.int32))
        else:
            cx, cy, scale = jroi.warp_affine_params(bb, (480, 640))
            out.append(np.array([cx, cy, max(scale, 1e-3)], np.float32))
    return np.stack(out)


_JROI = {"crop_square_resize": jroi.extract_roi_square,
         "crop_resize": jroi.extract_roi_clipped,
         "crop_resize_by_warp_affine": jroi.extract_roi_affine}
_TROI = {"crop_square_resize": troi.extract_roi_square,
         "crop_resize": troi.extract_roi_clipped,
         "crop_resize_by_warp_affine": troi.extract_roi_affine}


@pytest.mark.parametrize("method", list(_JROI))
@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_device_crops_match_jax(method, interp):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (len(BBOXES), 480, 640, 3)).astype(
        np.float32)
    params = _roi_params(method)
    crop = 64
    want = jax.vmap(lambda im, p: _JROI[method](im, p, crop, interp))(
        jnp.asarray(imgs), jnp.asarray(params))
    got = _TROI[method](_t(imgs), _t(params), crop, interp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_map_pixels_to_original_exact():
    px = np.stack(np.meshgrid(np.arange(128), np.arange(128)),
                  -1).reshape(-1, 2).astype(np.int32)
    for bb in ([7, -3, 100, 100], [300, 200, 173, 173], [-40, -25, 96, 97]):
        bb = np.array(bb, np.int32)
        np.testing.assert_array_equal(
            troi.map_pixels_to_original(_t(px), _t(bb), 128).numpy(),
            np.asarray(jroi.map_pixels_to_original(
                jnp.asarray(px), jnp.asarray(bb), 128)))


@pytest.mark.parametrize("include_gt", [False, True])
def test_preprocess_batch_matches_jax(include_gt):
    rng = np.random.default_rng(6)
    B = len(BBOXES)
    ids = rng.integers(0, 2 ** 16, (B, 480, 640)).astype(np.int32)
    raw = {
        "rgb": rng.integers(0, 256, (B, 480, 640, 3), dtype=np.uint8),
        "label": np.asarray(jsc.class_id_to_rgb(jnp.asarray(ids))),
        "mask": (rng.random((B, 480, 640)) > 0.5).astype(np.uint8) * 255,
        "entire_mask": (rng.random((B, 480, 640)) > 0.3).astype(
            np.uint8) * 255,
        "roi_param": _roi_params("crop_square_resize"),
        "valid": np.array([1, 1, 0, 1], np.float32),
    }
    want = j_preprocess({k: jnp.asarray(v) for k, v in raw.items()},
                        jax.random.PRNGKey(0), crop_img=64, crop_gt=32,
                        is_train=False, include_gt=include_gt)
    got = preprocess_batch({k: _t(v) for k, v in raw.items()}, crop_img=64,
                           crop_gt=32, include_gt=include_gt)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(want["image"]), atol=1e-4)
    for k in set(got) - {"image"}:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
