"""TIFF reader in place of cv2's: what `cv2.imread` returns, bit for bit.

itodd's test frames are `gray/*.tif` (read with IMREAD_COLOR by
`data/bop_io.py`) and the card's machine has neither cv2 nor PIL. The
container is parsed here in numpy; the LZW and PackBits strip codecs are
host C++ (`csrc/image_decode.cpp`, built by `ops/_build.py`), Deflate is
zlib's.

Supported: one image (the first IFD), strips, chunky samples of 8 or 16
bits, gray (BlackIsZero; with an alpha sample, as PIL writes "LA") and
RGB(A); compression 1 (none), 5 (LZW), 8 and 32946 (Deflate), 32773
(PackBits), each with or without the horizontal predictor (2).
Anything else (tiles, planar samples, palettes, WhiteIsZero, CMYK,
YCbCr, floating point, other bit depths, 16-bit unassociated alpha, an
orientation other than 1, BigTIFF, old-style LZW) raises
NotImplementedError naming it.

What cv2 (libtiff's RGBA interface for 8-bit output) returns:

  * IMREAD_UNCHANGED: the stored samples, uint16 kept; gray [H, W] (its
    alpha dropped), BGR or BGRA (an 8-bit unassociated alpha
    premultiplies the colour, as under IMREAD_COLOR).
  * IMREAD_COLOR: BGR uint8. 16-bit gray keeps its high byte (>> 8),
    16-bit colour is rounded ((v + 128) // 257); gray is replicated; an
    unassociated alpha (ExtraSamples 2) premultiplies the colour,
    (v * a + 127) // 255, otherwise alpha is dropped.
  * IMREAD_GRAYSCALE: gray as above; colour (after the same 8-bit
    conversion) weighted as cv2's icvCvt_BGR2Gray: (1868 B + 9617 G +
    4899 R + 8192) >> 14, i.e. rounded, not truncated as for PNG.

A malformed file (a short strip, a bad offset, a broken stream) gives
None, as cv2 does.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from zebrapose_tpu_torch.data.png import (
    IMREAD_COLOR,
    IMREAD_GRAYSCALE,
    IMREAD_UNCHANGED,
)

_TYPES = {1: "B", 3: "H", 4: "I", 16: "Q"}    # BYTE, SHORT, LONG, LONG8
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 16: 8}
# none, LZW, Deflate (two codes), PackBits
_COMPRESSIONS = (1, 5, 8, 32946, 32773)


class TIFFError(ValueError):
    """A malformed TIFF file (imread turns it into None)."""


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not supported by the port's "
                               "TIFF reader")


def _lib() -> ctypes.CDLL:
    from zebrapose_tpu_torch.ops import _build

    lib = _build.load("image_decode")
    if lib.zd_tiff_lzw.argtypes is None:
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        for fn in (lib.zd_tiff_lzw, lib.zd_tiff_packbits):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p,
                           ctypes.c_size_t]
            fn.restype = ctypes.c_long
    return lib


def _ifd(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """The byte order and the first IFD's tags with integer values."""
    if data[:4] in (b"II+\x00", b"MM\x00+"):
        raise _unsupported("BigTIFF")
    e = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise TIFFError("short header")
    (off,) = struct.unpack(e + "I", data[4:8])
    if off + 2 > len(data):
        raise TIFFError("IFD offset past the end")
    (n,) = struct.unpack(e + "H", data[off:off + 2])
    tags = {}
    for i in range(n):
        at = off + 2 + 12 * i
        if at + 12 > len(data):
            raise TIFFError("IFD past the end")
        tag, kind, count = struct.unpack(e + "HHI", data[at:at + 8])
        if kind not in _TYPES:
            continue                       # ASCII, rationals: not needed
        size = _SIZES[kind] * count
        if size <= 4:
            raw = data[at + 8:at + 8 + size]
        else:
            (vo,) = struct.unpack(e + "I", data[at + 8:at + 12])
            raw = data[vo:vo + size]
            if len(raw) != size:
                raise TIFFError(f"tag {tag} past the end")
        tags[tag] = struct.unpack(e + _TYPES[kind] * count, raw)
    return e, tags


def _strip(lib, comp: int, raw: bytes, size: int) -> bytes:
    if comp == 1:
        return raw[:size]
    if comp in (8, 32946):
        try:
            return zlib.decompressobj().decompress(raw, size)
        except zlib.error as err:
            raise TIFFError(str(err)) from err
    out = np.empty(size, np.uint8)
    if comp == 5:
        if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
            raise _unsupported("old-style (LSB-first) LZW")
        got = lib.zd_tiff_lzw(raw, len(raw), out, size)
    else:
        got = lib.zd_tiff_packbits(raw, len(raw), out, size)
    if got < 0:
        raise TIFFError("broken LZW stream")
    return out[:got].tobytes()


def decode_samples(data: bytes) -> Tuple[np.ndarray, int, int]:
    """A TIFF file -> (samples [H, W, spp] uint8 | uint16, photometric,
    ExtraSamples value or 0)."""
    e, tags = _ifd(data)

    def one(tag, default=None):
        v = tags.get(tag)
        if v is None:
            if default is None:
                raise TIFFError(f"missing tag {tag}")
            return default
        return v[0]

    if 322 in tags or 324 in tags:
        raise _unsupported("tiled TIFF")
    w, h = one(256), one(257)
    spp = one(277, 1)
    bps = tags.get(258, (1,))
    comp = one(259, 1)
    photometric = one(262)
    extra = one(338, 0)
    for tag, default, what in ((284, 1, "planar (separate) samples"),
                               (266, 1, "FillOrder 2"),
                               (274, 1, "an orientation other than 1"),
                               (339, 1, "a non-integer SampleFormat")):
        if any(v != default for v in tags.get(tag, (default,))):
            raise _unsupported(f"TIFF with {what}")
    if comp not in _COMPRESSIONS:
        raise _unsupported(f"TIFF compression {comp}")
    if len(set(bps)) != 1 or bps[0] not in (8, 16):
        raise _unsupported(f"TIFF with {bps} bits a sample")
    if (photometric, spp) not in ((1, 1), (1, 2), (2, 3), (2, 4)):
        raise _unsupported(f"TIFF photometric {photometric} with {spp} "
                           "samples a pixel")
    if spp == 4 and extra == 2 and bps[0] == 16:
        raise _unsupported("16-bit TIFF with unassociated alpha")
    predictor = one(317, 1)
    if predictor not in (1, 2):
        raise _unsupported(f"TIFF predictor {predictor}")
    nbytes = bps[0] // 8
    rows = min(one(278, h), h)
    offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None or len(offsets) != len(counts):
        raise TIFFError("strip offsets / byte counts")
    if len(offsets) < -(-h // rows):
        raise TIFFError("too few strips")
    row_bytes = w * spp * nbytes
    lib = _lib() if comp in (5, 32773) else None
    parts = []
    for s in range(-(-h // rows)):
        n_rows = min(rows, h - s * rows)
        raw = data[offsets[s]:offsets[s] + counts[s]]
        part = _strip(lib, comp, raw, n_rows * row_bytes)
        if len(part) < n_rows * row_bytes:
            raise TIFFError("short strip")
        parts.append(part)
    dtype = np.dtype(e + "u2") if nbytes == 2 else np.dtype(np.uint8)
    px = np.frombuffer(b"".join(parts), dtype).astype(
        np.uint16 if nbytes == 2 else np.uint8).reshape(h, w, spp)
    if predictor == 2:
        px = px.cumsum(axis=1, dtype=px.dtype)
    return px, photometric, extra


def _to_8bit(px: np.ndarray, photometric: int, extra: int) -> np.ndarray:
    """libtiff's RGBA conversion of the samples: uint8 gray [H, W, 1] or
    RGB [H, W, 3]."""
    if photometric == 1:
        g = px[..., :1]
        return (g >> 8).astype(np.uint8) if g.dtype == np.uint16 else g
    x = px.astype(np.int64)
    if px.dtype == np.uint16:
        x = (x + 128) // 257
    rgb = x[..., :3]
    if px.shape[-1] == 4 and extra == 2:     # unassociated alpha
        rgb = (rgb * x[..., 3:] + 127) // 255
    return rgb.astype(np.uint8)


def convert(px: np.ndarray, photometric: int, extra: int,
            flags: int) -> np.ndarray:
    """Decoded samples -> the array cv2.imread returns under `flags`."""
    if flags == IMREAD_UNCHANGED:
        if photometric == 1:
            return px[..., 0]
        if px.shape[-1] == 4 and extra == 2:   # 8-bit: premultiplied
            px = np.concatenate([_to_8bit(px, photometric, extra),
                                 px[..., 3:]], -1)
        order = [2, 1, 0] + ([3] if px.shape[-1] == 4 else [])
        return np.ascontiguousarray(px[..., order])
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"unsupported imread flags {flags}")
    v = _to_8bit(px, photometric, extra)
    if flags == IMREAD_COLOR:
        return np.repeat(v, 3, -1) if v.shape[-1] == 1 \
            else np.ascontiguousarray(v[..., ::-1])
    if v.shape[-1] == 1:
        return v[..., 0]
    x = v.astype(np.int32)
    return ((1868 * x[..., 2] + 9617 * x[..., 1] + 4899 * x[..., 0]
             + 8192) >> 14).astype(np.uint8)


def decode(data: bytes, flags: int = IMREAD_COLOR) -> Optional[np.ndarray]:
    """A TIFF file's bytes -> the array cv2.imread returns under `flags`;
    None when the file is malformed."""
    try:
        return convert(*decode_samples(data), flags)
    except (TIFFError, struct.error, IndexError):
        return None
