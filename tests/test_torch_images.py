"""The port's JPEG, TIFF and Adam7 readers against `cv2.imread`, the
reader of the JAX package: equal arrays (shape, dtype, every byte) under
IMREAD_COLOR, IMREAD_GRAYSCALE and IMREAD_UNCHANGED.

JPEG files are what cv2 writes (samplings 4:2:0 / 4:2:2 / 4:4:4 / 4:4:0
/ 4:1:1, qualities 50 / 95 / 100, optimised Huffman tables, restart
intervals, gray, odd sizes) plus an EXIF orientation spliced in here and
files cut short; TIFF files are cv2's and PIL's (no compression, LZW,
Deflate, PackBits; with and without the predictor; 8 and 16 bits; gray,
BGR, BGRA, gray + alpha; several strips); Adam7 PNG files come from a
small numpy interlacing encoder (`make_fixtures.adam7_png`). The
committed fixtures under `tests/data/torch_images/` are re-derived with
cv2 here (the card's machine, which has no cv2, is held to them by
chip_smoke.py). The training dataset collates a `.jpg` frame byte-equal
to the JAX package's.
"""

import json
import os
import shutil
import struct
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from zebrapose_tpu_torch.data import jpeg, png, tiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "torch_images")
sys.path.insert(0, FIXTURES)
import make_fixtures  # noqa: E402

FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)
SHAPES = ((1, 1), (17, 9), (37, 53), (2, 3), (16, 16))
SAMPLINGS = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _same(got, want, what):
    assert got is not None, what
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def _reads_as_cv2(path, what=""):
    for flag in FLAGS:
        _same(png.imread(str(path), flag), cv2.imread(str(path), flag),
              (what, flag))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("option", ["plain", "optimize", "restart"])
def test_jpeg_equals_cv2(sampling, option):
    rng = np.random.default_rng(0)
    extra = {"plain": [], "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
             "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1]}[option]
    for h, w in SHAPES:
        img = make_fixtures.smooth_image(h, w, rng)
        for q in (50, 95, 100):
            ok, buf = cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                SAMPLINGS[sampling]] + extra)
            for flag in FLAGS:
                _same(jpeg.decode(buf.tobytes(), flag),
                      cv2.imdecode(buf, flag), (h, w, q, flag))


def test_jpeg_gray_and_full_frame(tmp_path):
    rng = np.random.default_rng(1)
    for h, w in SHAPES:
        p = tmp_path / f"g{h}x{w}.jpg"
        cv2.imwrite(str(p), make_fixtures.smooth_image(h, w, rng, 1))
        _reads_as_cv2(p, (h, w))
    frame = np.clip(rng.normal(128, 50, (480, 640, 3)), 0, 255).astype(
        np.uint8)
    p = tmp_path / "frame.jpg"
    cv2.imwrite(str(p), frame)
    _reads_as_cv2(p, "480x640")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation(tmp_path, orientation):
    img = make_fixtures.smooth_image(37, 53, np.random.default_rng(2))
    data = make_fixtures.splice_exif(cv2.imencode(".jpg", img)[1].tobytes(),
                                     orientation)
    p = tmp_path / "exif.jpg"
    p.write_bytes(data)
    assert jpeg.exif_orientation(data) == orientation
    _reads_as_cv2(p, orientation)


def test_jpeg_cut_short_reads_as_cv2(tmp_path):
    """A file that ends inside its entropy-coded data: libjpeg reads the
    missing bits as zeros and the rest of the image as uniform gray."""
    rng = np.random.default_rng(3)
    img = np.clip(rng.normal(128, 40, (64, 80, 3)), 0, 255).astype(np.uint8)
    for params in ([], [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]):
        data = cv2.imencode(".jpg", img, params)[1].tobytes()
        for cut in (700, len(data) // 2, len(data) - 2):
            p = tmp_path / f"cut{cut}.jpg"
            p.write_bytes(data[:cut])
            _reads_as_cv2(p, cut)


def _sof_stream(marker, precision=8, components=3):
    """SOI and a frame header only: enough for the refusals."""
    body = struct.pack(">BHHB", precision, 16, 16, components) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(components))
    return (b"\xff\xd8" + bytes([0xFF, marker])
            + struct.pack(">H", len(body) + 2) + body + b"\xff\xd9")


@pytest.mark.parametrize("kind,stream", [
    ("progressive", "cv2"),
    ("arithmetic", _sof_stream(0xC9)),
    ("lossless", _sof_stream(0xC3)),
    ("12-bit", _sof_stream(0xC1, precision=12)),
    ("CMYK", _sof_stream(0xC0, components=4)),
    ("hierarchical", _sof_stream(0xC5))])
def test_jpeg_refusals_raise_by_name(kind, stream):
    if stream == "cv2":
        stream = cv2.imencode(".jpg", np.zeros((16, 16, 3), np.uint8),
                              [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    with pytest.raises(NotImplementedError, match=kind):
        jpeg.decode(stream)


def test_jpeg_malformed_gives_none(tmp_path):
    data = cv2.imencode(".jpg", np.zeros((16, 16, 3), np.uint8))[1].tobytes()
    sos = data.index(b"\xff\xda")
    for bad in (b"\xff\xd8", b"\xff\xd8garbage", data[:sos] + b"\xff\xd9",
                data[:20]):
        p = tmp_path / "bad.jpg"
        p.write_bytes(bad)
        assert png.imread(str(p)) is None
        assert cv2.imread(str(p)) is None


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_tiff_equals_cv2(tmp_path, depth, channels):
    rng = np.random.default_rng(4)
    dtype = np.uint8 if depth == 8 else np.uint16
    p = tmp_path / "t.tif"
    for comp in (1, 5, 8, 32946, 32773):
        for pred in (1, 2):
            for rows in (0, 7):
                for h, w in ((37, 53), (1, 1), (17, 9)):
                    img = make_fixtures.smooth_image(h, w, rng, channels,
                                                     dtype)
                    params = [cv2.IMWRITE_TIFF_COMPRESSION, comp,
                              cv2.IMWRITE_TIFF_PREDICTOR, pred]
                    if rows:
                        params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows]
                    assert cv2.imwrite(str(p), img, params)
                    _reads_as_cv2(p, (comp, pred, rows, h, w))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_pil_tiff_equals_cv2(tmp_path, mode):
    rng = np.random.default_rng(5)
    shape = {"L": (20, 30), "LA": (20, 30, 2), "RGB": (20, 30, 3),
             "RGBA": (20, 30, 4), "I;16": (20, 30)}[mode]
    top = 65536 if mode == "I;16" else 256
    arr = rng.integers(0, top, shape).astype(
        np.uint16 if mode == "I;16" else np.uint8)
    for comp in ("raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                 "packbits"):
        p = tmp_path / f"{comp}.tif"
        im = Image.frombytes(mode, arr.shape[1::-1], arr.tobytes()) \
            if mode == "I;16" else Image.fromarray(arr, mode)
        im.save(str(p), compression=comp)
        _reads_as_cv2(p, comp)


def test_tiff_refusals_and_malformed(tmp_path):
    img = make_fixtures.smooth_image(9, 7, np.random.default_rng(6))
    data = bytearray(cv2.imencode(".tif", img)[1].tobytes())
    e, tags = tiff._ifd(bytes(data))
    assert (tags[259], tags[317]) == ((5,), (2,))   # cv2: LZW, predictor
    (off,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[off:off + 2])
    for i in range(n):                     # planar configuration 1 -> 2
        at = off + 2 + 12 * i
        if struct.unpack("<H", data[at:at + 2])[0] == 284:
            data[at + 8:at + 10] = struct.pack("<H", 2)
    with pytest.raises(NotImplementedError, match="planar"):
        tiff.decode(bytes(data))
    with pytest.raises(NotImplementedError, match="BigTIFF"):
        tiff.decode(b"II+\x00" + b"\x00" * 12)
    good = cv2.imencode(".tif", img)[1].tobytes()
    for bad in (good[:12], good[:len(good) // 2] + b"\x00" * 4):
        p = tmp_path / "bad.tif"
        p.write_bytes(bad)
        assert png.imread(str(p)) is None


# ---------------------------------------------------------------------------
# Adam7 PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bgr", "gray", "gray16", "bgr16"])
def test_adam7_png_equals_cv2(tmp_path, kind):
    rng = np.random.default_rng(7)
    for h, w in ((1, 1), (1, 9), (7, 5), (33, 17), (8, 8), (3, 2)):
        dtype = np.uint16 if kind.endswith("16") else np.uint8
        img = make_fixtures.smooth_image(h, w, rng,
                                         1 if "gray" in kind else 3, dtype)
        p = tmp_path / "i.png"
        p.write_bytes(make_fixtures.adam7_png(img))
        assert png.decode(p.read_bytes())["samples"].shape[:2] == (h, w)
        _reads_as_cv2(p, (h, w))
        _same(png.imread(str(p), png.IMREAD_UNCHANGED), img, "round trip")


def test_imread_tells_formats_by_content(tmp_path):
    """A JPEG stream named .png, a PNG named .jpg and a TIFF named .dat
    read as what they hold, as cv2 reads them."""
    img = make_fixtures.smooth_image(17, 9, np.random.default_rng(8))
    for ext, name in ((".jpg", "x.png"), (".png", "x.jpg"),
                      (".tif", "x.dat")):
        p = tmp_path / name
        p.write_bytes(cv2.imencode(ext, img)[1].tobytes())
        _reads_as_cv2(p, name)


# ---------------------------------------------------------------------------
# The committed fixtures and the training dataset on .jpg frames
# ---------------------------------------------------------------------------

def test_committed_fixtures_match_cv2_and_the_port():
    """Every manifest hash is cv2's decode of the committed file on this
    host, and the port's; the progressive file is refused; the frames are
    the sphere frames chip_smoke regenerates, to at least 30 dB of luma
    PSNR (42.3 dB here). Their backgrounds are per-pixel random colours,
    whose chroma the default 4:2:0 subsampling averages away: over BGR
    the PSNR is 12.8 dB, over the sphere's pixels 30.0-30.6 dB."""
    import chip_smoke

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    files = sorted(n for n in os.listdir(FIXTURES)
                   if n.endswith((".jpg", ".tif", ".png")))
    assert files == sorted(manifest)
    assert make_fixtures.manifest(
        {n: open(os.path.join(FIXTURES, n), "rb").read() for n in files}) \
        == manifest
    for name, rec in manifest.items():
        path = os.path.join(FIXTURES, name)
        if "raises" in rec:
            with pytest.raises(NotImplementedError, match=rec["raises"]):
                png.imread(path)
            continue
        for key, flag in make_fixtures.FLAGS.items():
            assert make_fixtures.array_record(png.imread(path, flag)) \
                == rec[key], (name, key)
    rays = chip_smoke.pixel_rays()
    for i in range(4):
        frame = chip_smoke.sphere_frame(
            np.random.default_rng([chip_smoke.TRAIN_SEED, i]), rays)[0]
        want = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float64)
        got = png.imread(os.path.join(FIXTURES, f"frame_{i:06d}.jpg"),
                         png.IMREAD_GRAYSCALE)
        mse = np.mean((got - want) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) >= 30.0, i


def test_training_collate_on_a_jpg_frame_equals_jax(tmp_path):
    """CropDatasetHost(is_train=True).collate over a train_pbr-style
    split whose rgb are .jpg frames: byte-equal to the JAX package's."""
    from zebrapose_tpu.data.pipeline import CropDatasetHost as JDataset
    from zebrapose_tpu_torch.data.pipeline import CropDatasetHost

    scene = tmp_path / "train_pbr" / "000001"
    labels = tmp_path / "train_pbr_GT_v2" / "000001"
    for d in (scene / "rgb", scene / "mask_visib", scene / "mask", labels):
        d.mkdir(parents=True)
    rng = np.random.default_rng(9)
    rgb, maskv, mask, gts, gtis, cams = [], [], [], [], [], []
    for i in range(2):
        shutil.copy(os.path.join(FIXTURES, f"frame_{i:06d}.jpg"),
                    scene / "rgb" / f"{i:06d}.jpg")
        m = np.zeros((480, 640), np.uint8)
        m[150:330, 200:420] = 255
        for sub in ("mask_visib", "mask"):
            cv2.imwrite(str(scene / sub / f"{i:06d}_000000.png"), m)
        cv2.imwrite(str(labels / f"{i:06d}_000000.png"),
                    rng.integers(0, 256, (480, 640, 3), dtype=np.uint8))
        rgb.append(str(scene / "rgb" / f"{i:06d}.jpg"))
        maskv.append([str(scene / "mask_visib" / f"{i:06d}_000000.png")])
        mask.append([str(scene / "mask" / f"{i:06d}_000000.png")])
        gts.append({"cam_R_m2c": np.eye(3).reshape(-1).tolist(),
                    "cam_t_m2c": [0.0, 0.0, 600.0], "obj_id": 1})
        gtis.append({"bbox_visib": [200, 150, 220, 180], "visib_fract": 1.0})
        cams.append({"cam_K": [572.4, 0, 325.3, 0, 573.6, 242.0, 0, 0, 1]})
    args = (str(tmp_path), "train_pbr", rgb, mask, maskv, gts, gtis, cams)
    got = CropDatasetHost(*args, is_train=True, seed=4).collate([0, 1, 1])
    want = JDataset(*args, is_train=True, seed=4).collate([0, 1, 1])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
