"""The port's PNG reader (`zebrapose_tpu_torch/data/png.py`) against
`cv2.imread`, the reader of the JAX package.

Files come from the three writers the package's data can come from:
cv2.imwrite (Sub on every row: BGR, gray, 16-bit gray and 16-bit BGR),
PIL (adaptive filters, RGB, RGBA, gray, gray+alpha, 16-bit gray,
palettes of 8, 4, 2 and 1 bits, tRNS transparency) and the port's own
writer (each filter type 0-4 on every row, and a mix). Shapes include
odd widths and one-row images. Every result must be byte-equal to
cv2's, with the same shape and dtype, under each flag the package uses
(IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED).
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

import torch_threads  # noqa: F401  (torch threads a worker)
from zebrapose_tpu_torch.data import png

FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)
SHAPES = ((1, 1), (1, 9), (7, 5), (33, 17))


def test_flag_values_are_cv2s():
    assert (png.IMREAD_COLOR, png.IMREAD_GRAYSCALE, png.IMREAD_UNCHANGED) \
        == FLAGS


def _image(kind, h, w, rng):
    if kind == "bgr":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "gray":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "gray16":
        return rng.integers(0, 65536, (h, w), dtype=np.uint16)
    if kind == "bgr16":
        return rng.integers(0, 65536, (h, w, 3), dtype=np.uint16)
    if kind == "bgra":
        return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    raise ValueError(kind)


def _assert_reads_as_cv2(path):
    for flag in FLAGS:
        want = cv2.imread(str(path), flag)
        got = png.imread(str(path), flag)
        assert got is not None, (path, flag)
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (path, flag, got.shape, want.shape, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{path} {flag}")


def _filter_types(path):
    """The filter byte of every row of an 8-bit-or-more PNG file."""
    data = open(path, "rb").read()
    ihdr = dict(png._chunks(data))[b"IHDR"]
    w, h, depth, ctype = struct.unpack(">IIBB", ihdr[:10])
    idat = b"".join(b for k, b in png._chunks(data) if k == b"IDAT")
    stride = w * png._CHANNELS[ctype] * depth // 8
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    return rows.reshape(h, stride + 1)[:, 0]


@pytest.mark.parametrize("kind", ["bgr", "gray", "gray16", "bgr16", "bgra"])
def test_cv2_written_files_read_as_cv2(kind, tmp_path):
    rng = np.random.default_rng(0)
    for h, w in SHAPES:
        p = tmp_path / f"{kind}_{h}x{w}.png"
        cv2.imwrite(str(p), _image(kind, h, w, rng))
        _assert_reads_as_cv2(p)


def _pil_image(mode, h, w, rng):
    arr = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgb = Image.fromarray(arr[..., :3], "RGB")
    kw = {}
    if mode in ("RGB", "RGB+tRNS"):
        im = rgb
        if mode == "RGB+tRNS":
            kw["transparency"] = tuple(int(v) for v in arr[0, 0, :3])
    elif mode == "RGBA":
        im = Image.fromarray(arr, "RGBA")
    elif mode in ("L", "L+tRNS"):
        im = Image.fromarray(arr[..., 0], "L")
        if mode == "L+tRNS":
            kw["transparency"] = int(arr[0, 0, 0])
    elif mode == "LA":
        im = rgb.convert("LA")
    elif mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65536, (h, w), dtype=np.uint16))
    elif mode == "1":
        im = Image.fromarray(arr[..., 0] > 127)
    else:                                   # palettes: P<colours>
        im = rgb.convert("P", palette=Image.ADAPTIVE, colors=int(mode[1:]))
        if mode == "P200":
            kw["transparency"] = 3
    return im, kw


@pytest.mark.parametrize("mode", ["RGB", "RGB+tRNS", "RGBA", "L", "L+tRNS",
                                  "LA", "I;16", "1", "P200", "P16", "P4",
                                  "P2"])
def test_pil_written_files_read_as_cv2(mode, tmp_path):
    rng = np.random.default_rng(1)
    for h, w in SHAPES:
        im, kw = _pil_image(mode, h, w, rng)
        p = tmp_path / f"{h}x{w}.png"
        im.save(str(p), **kw)
        _assert_reads_as_cv2(p)


def test_pil_adaptive_filters_on_a_frame(tmp_path):
    """A 480x640 frame that PIL writes with a mix of all five filters."""
    rng = np.random.default_rng(2)
    img = np.clip(rng.normal(128, 30, (480, 640, 3)), 0, 255).astype(
        np.uint8)
    yy, xx = np.mgrid[0:480, 0:640]
    img[100:380, 150:500] = np.stack(
        [(xx + yy) % 256, (2 * xx) % 256, yy % 256],
        -1)[100:380, 150:500].astype(np.uint8)
    p = tmp_path / "frame.png"
    Image.fromarray(img).save(str(p))
    kinds = set(_filter_types(p).tolist())
    assert {1, 2, 4} <= kinds, kinds       # PIL's adaptive mix
    _assert_reads_as_cv2(p)
    np.testing.assert_array_equal(png.imread(str(p)), img[..., ::-1])


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mix"])
@pytest.mark.parametrize("kind", ["bgr", "gray", "gray16", "bgr16", "bgra"])
def test_port_writer_each_filter(kind, filters, tmp_path):
    rng = np.random.default_rng(3)
    for h, w in SHAPES:
        img = _image(kind, h, w, rng)
        f = np.arange(h) % 5 if filters == "mix" else filters
        p = tmp_path / f"{h}x{w}.png"
        assert png.imwrite(str(p), img, filters=f)
        np.testing.assert_array_equal(
            _filter_types(p), np.broadcast_to(f, (h,)))
        np.testing.assert_array_equal(
            cv2.imread(str(p), cv2.IMREAD_UNCHANGED), img)
        _assert_reads_as_cv2(p)


def test_missing_and_corrupt_files_give_none(tmp_path):
    assert png.imread(str(tmp_path / "absent.png")) is None
    assert cv2.imread(str(tmp_path / "absent.png")) is None
    p = tmp_path / "a.png"
    png.imwrite(str(p), np.zeros((4, 4, 3), np.uint8))
    data = bytearray(p.read_bytes())
    data[40] ^= 0xFF                       # inside the IDAT chunk
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    assert png.imread(str(bad)) is None
    (tmp_path / "text.png").write_text("not an image")
    assert png.imread(str(tmp_path / "text.png")) is None


def test_interlaced_jpeg_and_tiff_raise(tmp_path):
    """The reader's refusals: interlaced PNG is read now (as cv2 reads
    it), progressive JPEG and tiled TIFF raise by name."""
    data = bytearray(png.encode(np.zeros((4, 4), np.uint8)))
    # IHDR body starts at byte 16; its last byte is the interlace method.
    # A 4x4 all-zero image in Adam7 order: the non-empty passes 1, 4, 5,
    # 6 and 7 hold 1x1, 1x1, 2x1, 2x2 and 4x2 pixels, as filtered rows of
    # zeros.
    data[16 + 12] = 1
    crc = zlib.crc32(bytes(data[12:16 + 13]))
    data[29:33] = struct.pack(">I", crc)
    idat = b"".join(b"\x00" + b"\x00" * w for w, rows in
                    ((1, 1), (1, 1), (2, 1), (2, 2), (4, 2)) for _ in
                    range(rows))
    body = zlib.compress(idat)
    data = bytes(data[:33]) + png._chunk(b"IDAT", body) + png._chunk(
        b"IEND", b"")
    p = tmp_path / "interlaced.png"
    p.write_bytes(data)
    _assert_reads_as_cv2(p)
    q = tmp_path / "x.jpg"
    cv2.imwrite(str(q), np.zeros((16, 16, 3), np.uint8),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive"):
        png.imread(str(q))
    ifd = [(256, 3, 16), (257, 3, 16), (258, 3, 8), (259, 3, 1),
           (262, 3, 1), (277, 3, 1), (322, 3, 16), (323, 3, 16),
           (324, 4, 8), (325, 4, 256)]
    tif = b"II*\x00" + struct.pack("<IH", 8, len(ifd)) + b"".join(
        struct.pack("<HHII", tag, kind, 1, v) for tag, kind, v in ifd)
    t = tmp_path / "tiled.tif"
    t.write_bytes(tif + b"\x00" * 300)
    with pytest.raises(NotImplementedError, match="tiled"):
        png.imread(str(t))
