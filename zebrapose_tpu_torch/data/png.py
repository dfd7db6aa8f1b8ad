"""PNG reader and writer in numpy and zlib, in place of cv2's.

The JAX package reads every image with `cv2.imread`; the port must run
where neither cv2 nor PIL is installed, so it decodes PNG itself. The
reader returns what `cv2.imread` returns for the three flags the
package uses:

  * IMREAD_COLOR: BGR uint8 [H, W, 3]. 16-bit samples keep their high
    byte (libpng's strip_16), alpha is dropped, gray is replicated.
  * IMREAD_GRAYSCALE: uint8 [H, W]. Colour is weighted as libpng's
    rgb_to_gray does for cv2 (0.299 R + 0.587 G + 0.114 B, 15-bit
    fixed point, truncated).
  * IMREAD_UNCHANGED: the stored samples, uint16 for 16-bit files; BGR
    or BGRA for colour, palette expanded (with alpha when it has tRNS).

A missing or unreadable file gives None, as cv2 does. Interlaced (Adam7)
files are read pass by pass: each of the 7 sub-images is unfiltered with
its own row width and scattered into the image. `imread` is the one
entry point for every image the port reads: it tells the format by the
file's first bytes and hands JPEG to `data/jpeg.py` (BOP `train_pbr`
rgb) and TIFF to `data/tiff.py` (itodd's gray frames).

Scanline filters: None, Sub and Up rows are undone with numpy (Sub is a
cumulative sum mod 256 along the row, a run of Up rows one down the
columns). Average and Paeth rows depend on the reconstructed byte to
their left, so they run as a Python loop over each channel's chain of
bytes; they are the slow part (PERF.md gives ms per frame by filter
mix).

`imwrite` writes 8/16-bit gray, BGR and BGRA arrays with the filter
type given row by row (cv2 writes Sub on every row).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

# cv2's flag values
IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples
# Adam7 passes: first column, first row, column step, row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

# libpng's png_set_rgb_to_gray(png, 1, 0.299, 0.587) coefficients
_GRAY_R = 29900 * 32768 // 100000
_GRAY_G = 58700 * 32768 // 100000
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


class PNGError(ValueError):
    """A malformed PNG stream (imread turns it into None)."""


# ---------------------------------------------------------------------------
# Chunks and scanline filters
# ---------------------------------------------------------------------------

def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise PNGError("truncated chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise PNGError(f"bad CRC in {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise PNGError("no IEND chunk")


def _average_chain(xs, bs):
    """One channel's bytes of an Average row: a = x + (left + up) // 2."""
    out = []
    put = out.append
    a = 0
    for x, b in zip(xs, bs):
        a = (x + ((a + b) >> 1)) & 255
        put(a)
    return out


def _paeth_chain(xs, bs):
    """One channel's bytes of a Paeth row (left a, up b, up-left c)."""
    out = []
    put = out.append
    a = c = 0
    for x, b in zip(xs, bs):
        pa = b - c
        pb = a - c
        pc = pa + pb
        if pa < 0:
            pa = -pa
        if pb < 0:
            pb = -pb
        if pc < 0:
            pc = -pc
        if pa <= pb and pa <= pc:
            a = (x + a) & 255
        elif pb <= pc:
            a = (x + b) & 255
        else:
            a = (x + c) & 255
        c = b
        put(a)
    return out


def _recursive_row(kind: int, cur: np.ndarray, up: np.ndarray,
                   bpp: int) -> np.ndarray:
    chain = _average_chain if kind == 3 else _paeth_chain
    out = np.empty_like(cur)
    for k in range(bpp):
        out[k::bpp] = chain(cur[k::bpp].tolist(), up[k::bpp].tolist())
    return out


def unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters: rows [H, 1 + stride] uint8 (filter byte
    first) -> [H, stride] uint8."""
    kinds, data = rows[:, 0], rows[:, 1:]
    if kinds.size and kinds.max() > 4:
        raise PNGError(f"unknown filter type {int(kinds.max())}")
    out = np.empty_like(data)
    h = data.shape[0]
    # None and Sub rows need no other row
    plain = kinds == 0
    out[plain] = data[plain]
    sub = np.nonzero(kinds == 1)[0]
    if sub.size:
        out[sub] = data[sub].reshape(sub.size, -1, bpp).cumsum(
            axis=1, dtype=np.uint8).reshape(sub.size, -1)
    zero = np.zeros(data.shape[1], np.uint8)
    r = 0
    while r < h:
        kind = kinds[r]
        if kind <= 1:
            r += 1
            continue
        up = out[r - 1] if r else zero
        if kind == 2:                      # a run of Up rows at once
            e = r + 1
            while e < h and kinds[e] == 2:
                e += 1
            out[r:e] = data[r:e].cumsum(axis=0, dtype=np.uint8) + up
            r = e
            continue
        out[r] = _recursive_row(int(kind), data[r], up, bpp)
        r += 1
    return out


def _filter_rows(samples: np.ndarray, kinds: np.ndarray,
                 bpp: int) -> np.ndarray:
    """[H, stride] uint8 -> [H, 1 + stride] filtered rows."""
    x = samples.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    pred = preds[kinds, np.arange(x.shape[0])]
    return np.concatenate([kinds[:, None].astype(np.uint8),
                           (x - pred).astype(np.uint8)], axis=1)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode(data: bytes) -> dict:
    """A PNG stream -> {"samples" [H, W, C] uint8 | uint16 (PNG channel
    order, palette indices for colour type 3), "color_type",
    "bit_depth", "palette" [n, 3] | None, "trns" bytes | None}."""
    if not data.startswith(_SIGNATURE):
        raise PNGError("not a PNG stream")
    ihdr, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise PNGError("IHDR is not 13 bytes")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if not body or len(body) % 3:
                raise PNGError("PLTE is not a list of RGB triples")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise PNGError("no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace > 1:
        raise PNGError(f"interlace method {interlace}")
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise PNGError(f"colour type {ctype} with bit depth {depth}")
    if ctype == 3 and palette is None:
        raise PNGError("palette image without PLTE")
    ch = _CHANNELS[ctype]
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as e:
        raise PNGError(str(e)) from e
    if not interlace:
        samples, _ = _pass_samples(raw, h, w, ch, depth)
    else:                                    # Adam7: 7 sub-images
        samples = np.empty((h, w, ch), np.uint16 if depth == 16
                           else np.uint8)
        for x0, y0, dx, dy in _ADAM7:
            ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
            if ph <= 0 or pw <= 0:
                continue                     # an empty pass has no bytes
            samples[y0::dy, x0::dx], used = _pass_samples(raw, ph, pw, ch,
                                                          depth)
            raw = raw[used:]
    return {"samples": samples, "color_type": ctype, "bit_depth": depth,
            "palette": palette, "trns": trns}


def _pass_samples(raw: bytes, h: int, w: int, ch: int, depth: int):
    """The first h filtered rows of a w-pixel (sub-)image in `raw` ->
    (samples [h, w, ch], bytes used)."""
    stride = (w * ch * depth + 7) // 8
    used = h * (stride + 1)
    if len(raw) < used:
        raise PNGError("image data too short")
    rows = np.frombuffer(raw, np.uint8, used).reshape(h, stride + 1)
    flat = unfilter(rows, max(1, ch * depth // 8))
    if depth == 16:
        return flat.view(">u2").astype(np.uint16).reshape(h, w, ch), used
    if depth == 8:
        return flat.reshape(h, w, ch), used
    per = 8 // depth                         # 1/2/4-bit gray or palette
    idx = np.unpackbits(flat, axis=1).reshape(h, stride * per, depth)
    vals = (idx * (1 << np.arange(depth - 1, -1, -1,
                                  dtype=np.uint8))).sum(-1)
    return vals[:, :w, None].astype(np.uint8), used


def _to_bgr_order(px: np.ndarray) -> np.ndarray:
    """RGB(A) -> BGR(A) (cv2's channel order)."""
    order = [2, 1, 0] + ([3] if px.shape[-1] == 4 else [])
    return px[..., order]


def _expand(png: dict):
    """Samples as gray / gray+alpha / RGB / RGBA, palette and sub-byte
    gray expanded; returns (pixels [H, W, C], has_colour, has_alpha)."""
    s, ctype, depth = png["samples"], png["color_type"], png["bit_depth"]
    trns = png["trns"]
    if ctype == 3:
        pal = png["palette"]
        if trns:
            alpha = np.full(len(pal), 255, np.uint8)
            t = np.frombuffer(trns, np.uint8)[:len(pal)]
            alpha[:len(t)] = t
            pal = np.concatenate([pal, alpha[:, None]], axis=1)
        idx = np.minimum(s[..., 0], len(pal) - 1)
        return pal[idx], True, bool(trns)
    if ctype == 0 and depth < 8:
        return s * np.uint8(255 // ((1 << depth) - 1)), False, False
    if ctype == 2 and trns:                  # one transparent colour
        key = np.array(struct.unpack(">HHH", trns[:6]), s.dtype)
        full = np.iinfo(s.dtype).max
        alpha = np.where((s == key).all(-1), 0, full).astype(s.dtype)
        return np.concatenate([s, alpha[..., None]], -1), True, True
    return s, ctype in (2, 6), ctype in (4, 6)


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's rgb_to_gray without gamma: a pixel whose three samples
    are equal keeps its value; others are weighted and truncated (8-bit)
    or rounded (16-bit)."""
    x = rgb.astype(np.int64)
    acc = _GRAY_R * x[..., 0] + _GRAY_G * x[..., 1] + _GRAY_B * x[..., 2]
    g = (acc + (16384 if rgb.dtype == np.uint16 else 0)) >> 15
    same = (x[..., 0] == x[..., 1]) & (x[..., 1] == x[..., 2])
    return np.where(same, x[..., 0], g).astype(rgb.dtype)


def convert(png: dict, flags: int) -> np.ndarray:
    """Decoded samples -> the array cv2.imread returns under `flags`."""
    px, colour, alpha = _expand(png)
    if flags == IMREAD_UNCHANGED:
        if png["color_type"] == 4:           # gray + alpha -> BGRA
            return np.concatenate([np.repeat(px[..., :1], 3, -1),
                                   px[..., 1:]], -1)
        if not colour:
            return px[..., 0]
        return _to_bgr_order(px)
    if alpha:
        px = px[..., :-1]
    if flags == IMREAD_GRAYSCALE:
        gray = _rgb_to_gray(px) if colour else px[..., 0]
        return (gray >> 8).astype(np.uint8) if gray.dtype == np.uint16 \
            else gray
    if flags != IMREAD_COLOR:
        raise ValueError(f"unsupported imread flags {flags}")
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    return _to_bgr_order(px) if colour else np.repeat(px, 3, -1)


def imread(path: str, flags: int = IMREAD_COLOR) -> Optional[np.ndarray]:
    """cv2.imread for PNG, JPEG and TIFF files; None when the file is
    missing or not a readable image. The format is told by the file's
    first bytes (the PNG signature, `\\xff\\xd8` for JPEG, `II*\\0` or
    `MM\\0*` for TIFF), not by its name, as cv2 tells it; JPEG goes to
    `data/jpeg.py`, TIFF to `data/tiff.py`."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data.startswith(b"\xff\xd8"):
        from zebrapose_tpu_torch.data import jpeg
        return jpeg.decode(data, flags)
    if data.startswith((b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")):
        from zebrapose_tpu_torch.data import tiff
        return tiff.decode(data, flags)
    try:
        return convert(decode(data), flags)
    except PNGError:
        return None


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(img: np.ndarray,
           filters: Union[int, Sequence[int]] = 1) -> bytes:
    """A gray [H, W] / BGR [H, W, 3] / BGRA [H, W, 4] uint8 or uint16
    array -> PNG bytes. `filters` is one filter type (0-4) for every
    row, or one per row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"imwrite takes uint8 or uint16, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype, px = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype, px = (2 if img.shape[2] == 3 else 6), _to_bgr_order(img)
    else:
        raise ValueError(f"cannot write an array of shape {img.shape}")
    h, w, ch = px.shape
    depth = 16 if px.dtype == np.uint16 else 8
    flat = np.ascontiguousarray(px.astype(">u2") if depth == 16 else px)
    flat = flat.view(np.uint8).reshape(h, -1)
    kinds = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    if kinds.size and (kinds.min() < 0 or kinds.max() > 4):
        raise ValueError("filter types are 0-4")
    rows = _filter_rows(flat, kinds, ch * depth // 8)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray,
            filters: Union[int, Sequence[int]] = 1) -> bool:
    """Write `img` as a PNG file (see `encode`); True as cv2 returns."""
    data = encode(img, filters)
    with open(path, "wb") as f:
        f.write(data)
    return True
