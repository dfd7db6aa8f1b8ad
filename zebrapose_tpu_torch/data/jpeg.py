"""JPEG reader in place of cv2's: what `cv2.imread` returns, bit for bit.

The JAX package reads BOP frames with `cv2.imread`; `train_pbr` splits
store rgb as `.jpg`, and the card's machine has neither cv2 nor PIL. The
decoding is host C++ (`csrc/image_decode.cpp`, built by `ops/_build.py`
at first use; a missing compiler raises, there is no Python decoder). It
follows libjpeg-turbo's defaults as cv2 uses them: the islow integer
IDCT, fancy chroma upsampling, 16-bit fixed-point YCbCr -> RGB.

Flags, as cv2 treats a JPEG file:

  * IMREAD_COLOR: BGR uint8 [H, W, 3]; a gray file is replicated.
  * IMREAD_GRAYSCALE: uint8 [H, W]; of a YCbCr file, its Y plane (the
    chroma is never converted).
  * IMREAD_UNCHANGED: as IMREAD_COLOR for a colour file, [H, W] for a
    gray one, and the EXIF orientation is not applied.

Under IMREAD_COLOR and IMREAD_GRAYSCALE the EXIF orientation (APP1, tag
0x0112) is applied as cv2's ApplyExifOrientation does: the 8 flips and
transposes.

Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files,
and Adobe CMYK / YCCK (4-component) files, raise NotImplementedError
naming the kind. A malformed stream gives None, as cv2 does. A file that
ends inside its entropy-coded data decodes as libjpeg decodes it (the
missing bits read as zeros, the rest of the image uniform gray), which
is what `cv2.imread` returns for it.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from zebrapose_tpu_torch.data.png import (
    IMREAD_COLOR,
    IMREAD_GRAYSCALE,
    IMREAD_UNCHANGED,
)

_REFUSED = {
    2: "progressive JPEG (SOF2)",
    3: "arithmetic-coded JPEG",
    4: "lossless JPEG (SOF3)",
    5: "JPEG with a sample precision other than 8 bits (12-bit)",
    6: "4-component JPEG (Adobe CMYK / YCCK)",
    7: "hierarchical JPEG",
    8: "JPEG with non-integral chroma sampling factors",
    9: "JPEG with other than 1 or 3 components",
}


def _lib() -> ctypes.CDLL:
    from zebrapose_tpu_torch.ops import _build

    lib = _build.load("image_decode")
    if lib.zd_jpeg_header.argtypes is None:
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.zd_jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       i32p]
        lib.zd_jpeg_header.restype = ctypes.c_int
        lib.zd_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_int, u8p]
        lib.zd_jpeg_decode.restype = ctypes.c_int
    return lib


def _check(rc: int) -> bool:
    """True for success, False for a malformed stream; raises for a kind
    of JPEG the decoder does not handle."""
    if rc in _REFUSED:
        raise NotImplementedError(f"{_REFUSED[rc]} is not supported by "
                                  "the port's JPEG decoder")
    return rc == 0


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) of a JPEG stream's APP1 segment; 1 when
    there is none or it cannot be read."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xDA, 0xD9):
            break
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + n]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return _tiff_orientation(body[6:])
        pos += 2 + n
    return 1


def _tiff_orientation(t: bytes) -> int:
    if len(t) < 8 or t[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if t[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", t[4:8])
    if ifd + 2 > len(t):
        return 1
    (count,) = struct.unpack(e + "H", t[ifd:ifd + 2])
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(t):
            break
        tag, kind = struct.unpack(e + "HH", t[at:at + 4])
        if tag == 0x0112 and kind == 3:
            (value,) = struct.unpack(e + "H", t[at + 8:at + 10])
            return value if 1 <= value <= 8 else 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ApplyExifOrientation: flips and transposes of the rows and
    columns (channels untouched)."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode(data: bytes, flags: int = IMREAD_COLOR) -> Optional[np.ndarray]:
    """A JPEG stream -> the array cv2.imread returns under `flags`; None
    for a malformed stream."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED):
        raise ValueError(f"unsupported imread flags {flags}")
    lib = _lib()
    info = np.zeros(3, np.int32)
    if not _check(lib.zd_jpeg_header(data, len(data), info)):
        return None
    w, h, comps = (int(v) for v in info)
    gray = flags == IMREAD_GRAYSCALE or (flags == IMREAD_UNCHANGED
                                         and comps == 1)
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    if not _check(lib.zd_jpeg_decode(data, len(data), int(gray), out)):
        return None
    if flags != IMREAD_UNCHANGED:
        out = apply_orientation(out, exif_orientation(data))
    return out
