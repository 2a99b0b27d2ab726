"""JPEG without PIL: the port's own baseline decoder (`csrc/jpeg_decode.cpp`).

  decode_jpeg(path_or_bytes) -> uint8 (H, W, 3) RGB, gray replicated
  jpeg_size(path_or_bytes)   -> (height, width) from the frame header

The decoder reads baseline and extended-sequential Huffman JPEGs of 8 bits
a sample: gray, and YCbCr sampled 4:4:4, 4:2:2 or 4:2:0, with restart
intervals and optimised Huffman tables. Its arithmetic is libjpeg's where
it decides a pixel (the `islow` integer IDCT, "fancy" triangular chroma
upsampling, the fixed-point YCbCr -> RGB tables), so its pixels equal
libjpeg-turbo's, and so PIL's `Image.open(p).convert("RGB")`, bit for bit.

Any other JPEG (progressive, lossless, arithmetic-coded, 12-bit, CMYK,
YCCK, RGB-coded, another sampling) raises `JpegRefused` naming the kind;
`utils.png.read_rgb` hands such a file to PIL where PIL imports. A file
that is not a readable JPEG raises `ValueError` naming the file, on every
machine: it never reaches PIL.

The source is built on first use with the host compiler into `_build/`
under a name that carries a hash of the source (`utils.host_build`, as
the PNG unfilter is), and bound through ctypes.
"""
from __future__ import annotations

import ctypes

import numpy as np

from gedepth_tpu_torch.utils.host_build import (
    PKG_DIR, build_host_library, read_bytes)

SOURCE = PKG_DIR / "csrc" / "jpeg_decode.cpp"
_MSG = 256

_lib = None


class JpegRefused(ValueError):
    """A JPEG of a kind the port's decoder does not read; `kind` names
    it."""

    def __init__(self, name, kind):
        super().__init__(f"{name}: a {kind} JPEG, which the port's decoder "
                         "does not read")
        self.kind = kind


def load_library():
    """Build (if needed) and load the decoder; idempotent."""
    global _lib
    if _lib is None:
        lib = build_host_library(SOURCE, "jpeg_decode")
        lib.jpeg_size.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int]
        lib.jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_size.restype = lib.jpeg_decode.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(rc, msg, name):
    if rc == 1:
        raise JpegRefused(name, msg.value.decode())
    if rc != 0:
        raise ValueError(f"{name}: not a readable JPEG "
                         f"({msg.value.decode()})")


def _size(data: bytes, name: str) -> tuple:
    hw = np.zeros(2, np.int32)
    msg = ctypes.create_string_buffer(_MSG)
    _check(load_library().jpeg_size(data, len(data), hw.ctypes.data, msg,
                                    _MSG), msg, name)
    return int(hw[0]), int(hw[1])


def jpeg_size(src) -> tuple:
    """(height, width) of a JPEG from its frame header."""
    return _size(*read_bytes(src))


def decode_jpeg(src) -> np.ndarray:
    """Decode a JPEG file (path) or its bytes; see the module docstring."""
    return decode_bytes(*read_bytes(src))


def decode_bytes(data: bytes, name: str = "<bytes>") -> np.ndarray:
    h, w = _size(data, name)
    out = np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    _check(load_library().jpeg_decode(data, len(data), out.ctypes.data,
                                      out.nbytes, msg, _MSG), msg, name)
    return out
