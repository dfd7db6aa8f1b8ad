"""Write the image fixtures of the port's readers and their manifest.

    python tests/data/torch_images/make_fixtures.py

Needs cv2 (the JAX package's reader); run it where cv2 is installed.
Writes, next to this script:

  * frame_00000{0-3}.jpg: frames 0-3 of `chip_smoke.write_train_split`'s
    generator (`sphere_frame(default_rng([TRAIN_SEED, i]))`), encoded by
    `cv2.imencode(".jpg", frame)` at cv2's defaults (quality 95, 4:2:0);
  * small edge cases: JPEG samplings 4:2:0 / 4:2:2 / 4:4:4 / 4:4:0 /
    4:1:1, a restart interval, optimised Huffman tables, quality 50 and
    100, gray, an EXIF orientation (6) spliced into APP1, a progressive
    file (which the port refuses); TIFF as cv2 writes it (LZW with the
    horizontal predictor) and with Deflate, PackBits, no compression,
    8 and 16 bits, gray, BGR and BGRA, several strips; an Adam7 PNG
    (`adam7_png`);
  * manifest.json: for each file, the shape, dtype and SHA-256 of
    `cv2.imread`'s array under IMREAD_COLOR, IMREAD_GRAYSCALE and
    IMREAD_UNCHANGED, or the name of the refusal the port raises;
  * sphere_sym_poses.npz: the poses of `chip_smoke.write_tree`'s 120
    frames canonicalized by the JAX package's `canonicalize_pose` under
    the sphere's continuous symmetry about z (R [120, 3, 3], t [120, 3]
    float64): what its `generate-labels` renders the symmetric labels
    from (needs the JAX package's numpy-only `tools/symmetry.py`).

`tests/test_torch_images.py` re-derives every hash with cv2 and holds the
port's readers to them; `chip_smoke.py` holds the port to them on the
card's machine, which has no cv2.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGS = {"color": 1, "gray": 0, "unchanged": -1}


def array_record(a: np.ndarray) -> dict:
    """Shape, dtype and SHA-256 of an image array (C order)."""
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def adam7_png(img: np.ndarray) -> bytes:
    """An interlaced (Adam7) PNG of a gray [H, W] / BGR [H, W, 3] uint8
    or uint16 array; each pass's rows carry filter type (row % 5)."""
    from zebrapose_tpu_torch.data import png

    if img.ndim == 2:
        ctype, px = 0, img[..., None]
    else:
        ctype, px = 2, img[..., ::-1]
    depth = 16 if img.dtype == np.uint16 else 8
    h, w, ch = px.shape
    rows = []
    for x0, y0, dx, dy in png._ADAM7:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        flat = np.ascontiguousarray(
            sub.astype(">u2") if depth == 16 else sub).view(
                np.uint8).reshape(sub.shape[0], -1)
        kinds = np.arange(sub.shape[0]) % 5
        rows.append(png._filter_rows(flat, kinds, ch * depth // 8)
                    .tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 1)
    return (png._SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + png._chunk(b"IEND", b""))


def smooth_image(h, w, rng, channels=3, dtype=np.uint8):
    """A smooth pattern with noise (what camera frames look like to a
    codec)."""
    top = np.iinfo(dtype).max
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([top / 2 + top / 2.3 * np.sin(x * 0.15 + k)
                    * np.cos(y * 0.11 * (k + 1)) for k in range(channels)],
                   -1) + rng.normal(0, top / 40, (h, w, channels))
    img = np.clip(img, 0, top).astype(dtype)
    return img[..., 0] if channels == 1 else img


def splice_exif(jpg: bytes, orientation: int) -> bytes:
    """`jpg` with an APP1 Exif segment holding one orientation tag."""
    ifd = (b"MM\x00\x2a\x00\x00\x00\x08" + struct.pack(">H", 1)
           + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
           + b"\x00\x00\x00\x00")
    body = b"Exif\x00\x00" + ifd
    return (jpg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
            + jpg[2:])


def fixtures() -> dict:
    """{file name: bytes} of every fixture."""
    import cv2

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    import chip_smoke

    out = {}
    rays = chip_smoke.pixel_rays()
    for i in range(4):
        frame = chip_smoke.sphere_frame(
            np.random.default_rng([chip_smoke.TRAIN_SEED, i]), rays)[0]
        out[f"frame_{i:06d}.jpg"] = cv2.imencode(".jpg", frame)[1].tobytes()
    rng = np.random.default_rng(20)
    img = smooth_image(37, 53, rng)

    def jpg(a, *params):
        return cv2.imencode(".jpg", a, list(params))[1].tobytes()

    S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    for name, code in (("420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
                       ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
                       ("444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                       ("440", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
                       ("411", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)):
        out[f"sampling_{name}.jpg"] = jpg(img, S, code)
    out["restart_2.jpg"] = jpg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    out["optimized.jpg"] = jpg(img, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    out["quality_50.jpg"] = jpg(img, cv2.IMWRITE_JPEG_QUALITY, 50)
    out["quality_100.jpg"] = jpg(img, cv2.IMWRITE_JPEG_QUALITY, 100)
    out["gray_17x9.jpg"] = jpg(smooth_image(17, 9, rng, 1))
    out["exif_6.jpg"] = splice_exif(jpg(img), 6)
    out["progressive.jpg"] = jpg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)

    def tif(a, comp, pred=2, rows=0):
        params = [cv2.IMWRITE_TIFF_COMPRESSION, comp,
                  cv2.IMWRITE_TIFF_PREDICTOR, pred]
        if rows:
            params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows]
        return cv2.imencode(".tif", a, params)[1].tobytes()

    out["lzw_bgr.tif"] = cv2.imencode(".tif", img)[1].tobytes()
    out["lzw_gray16_strips.tif"] = tif(
        smooth_image(37, 53, rng, 1, np.uint16), 5, 2, 8)
    out["deflate_bgr16.tif"] = tif(smooth_image(21, 19, rng, 3, np.uint16),
                                   8)
    out["packbits_bgra.tif"] = tif(smooth_image(21, 19, rng, 4), 32773, 1)
    out["none_gray.tif"] = tif(smooth_image(21, 19, rng, 1), 1, 1)
    out["adam7_bgr.png"] = adam7_png(smooth_image(21, 19, rng))
    return out


def manifest(files: dict) -> dict:
    """cv2's decode of each fixture, as `array_record`s by flag; the
    refusal's name for the file the port refuses."""
    import cv2

    res = {}
    for name, data in sorted(files.items()):
        if name == "progressive.jpg":
            res[name] = {"raises": "progressive"}
            continue
        buf = np.frombuffer(data, np.uint8)
        res[name] = {k: array_record(cv2.imdecode(buf, f))
                     for k, f in FLAGS.items()}
    return res


def symmetric_poses() -> dict:
    """`chip_smoke.write_tree`'s frame poses, canonicalized by the JAX
    package under a continuous symmetry about z."""
    import chip_smoke
    from zebrapose_tpu.tools.symmetry import canonicalize_pose

    _, _, _, (Rs, ts) = chip_smoke.sphere_frames(
        chip_smoke.TREE_FRAMES, np.random.default_rng(chip_smoke.TREE_SEED))
    info = {"symmetries_continuous": [{"axis": [0, 0, 1],
                                       "offset": [0, 0, 0]}]}
    poses = [canonicalize_pose(R, t, info) for R, t in zip(Rs, ts)]
    return {"R": np.stack([R for R, _ in poses]),
            "t": np.stack([t.reshape(3) for _, t in poses])}


def main() -> int:
    files = fixtures()
    np.savez(os.path.join(HERE, "sphere_sym_poses.npz"), **symmetric_poses())
    for name, data in files.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest(files), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(files)} fixtures and manifest.json to {HERE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
