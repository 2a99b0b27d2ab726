"""PNG without PIL: the reader of the port's data path and a plain writer.

  read_png(path_or_bytes)          -> uint8 (H, W) | (H, W, 3), uint16 (H, W)
  read_rgb(path_or_bytes)          -> float32 (H, W, 3), 0..255 (PNG or
                                      JPEG)
  load_depth_png(path, scale)      -> float32 (H, W) metres
  png_size(path)                   -> (height, width) from the header
  write_png(path, array)           -> 8-bit gray or RGB, 16-bit gray

`read_png` decodes colour types 0 (gray, 8 or 16 bits, 16 big-endian), 2
(RGB), 3 (palette, looked up to RGB), 4 and 6 (gray and RGB with alpha,
the alpha dropped as PIL's `convert("RGB")` drops it), 8 bits a channel,
from any number of IDAT chunks and with all five scanline filters.
Adam7-interlaced files and other bit depths raise `ValueError` naming the
file. `read_rgb` is
`np.asarray(Image.open(p).convert("RGB"), np.float32)` of the JAX package's
datasets: gray is replicated into three channels. It tells the format by
its magic bytes: a JPEG goes to the port's decoder (`utils.jpeg`, equal
to PIL's pixels), and one of a kind that decoder does not read to PIL,
imported only then; without PIL that raises ImportError naming the file
and the kind.

The inflate is the standard library's zlib. Unfiltering is sequential along a
row (the Sub, Average and Paeth filters read the byte one pixel to the
left), so it runs in a small host C++ source (`csrc/png_unfilter.cpp`),
built on first use with the host compiler into `_build/` under a name that
carries a hash of the source, and bound through ctypes
(`utils.host_build`; `load_library`). A failed build raises.
`unfilter_plain` is the numpy version, row by row, that the tests hold the
C++ one against.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from gedepth_tpu_torch.utils.host_build import (
    PKG_DIR, build_host_library, host_library_path, read_bytes)

SOURCE = PKG_DIR / "csrc" / "png_unfilter.cpp"
SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# colour type -> channels in the file
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

_lib = None


def library_path() -> Path:
    return host_library_path(SOURCE, "png_unfilter")


def load_library():
    """Build (if needed) and load the unfilter library; idempotent. A
    loader calls it before it starts its worker processes, so that they
    find the library built and load it rather than each build it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build_host_library(SOURCE, "png_unfilter")
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_int
    _lib = lib
    return lib


def unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The reconstructed (height, stride) bytes of inflated scanlines, by
    the C++ loop."""
    if len(data) < height * (stride + 1) or not 1 <= bpp <= 8:
        raise ValueError(f"{len(data)} bytes cannot hold {height} scanlines "
                         f"of {stride} bytes ({bpp} a pixel)")
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, stride), np.uint8)
    rc = load_library().png_unfilter(src.ctypes.data, out.ctypes.data,
                                     height, stride, bpp)
    if rc != 0:
        raise ValueError(f"unknown PNG filter type in row {rc - 1}")
    return out


def unfilter_plain(data: bytes, height: int, stride: int,
                   bpp: int) -> np.ndarray:
    """`unfilter` in numpy, row by row: the reference of the C++ loop."""
    rows = np.frombuffer(data, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(height):
        kind, raw = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 0:
            row = raw
        elif kind == 2:
            row = (raw + prior) % 256
        elif kind in (1, 3, 4):
            row = np.zeros(stride, np.int64)
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + prior[i]) // 2
                else:
                    b = prior[i]
                    c = prior[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[i] = (raw[i] + pred) % 256
        else:
            raise ValueError(f"unknown PNG filter type in row {y}")
        out[y] = row
        prior = row
    return out


def _chunks(data, name):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: truncated PNG (no IEND chunk)")


def _header(data, name):
    for kind, body in _chunks(data, name):
        if kind != b"IHDR":
            raise ValueError(f"{name}: the first chunk is not IHDR")
        return struct.unpack(">IIBBBBB", body[:13])
    raise ValueError(f"{name}: no IHDR chunk")


def png_size(src) -> tuple:
    """(height, width) of a PNG from its header; reads the first 33 bytes
    of a file."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        head, name = bytes(src[:33]), "<bytes>"
    else:
        with open(src, "rb") as f:
            head, name = f.read(33), os.fspath(src)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{name}: not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def read_png(src) -> np.ndarray:
    """Decode a PNG file (path) or its bytes; see the module docstring."""
    return _decode_png(*read_bytes(src))


def _decode_png(data: bytes, name: str) -> np.ndarray:
    width, height, depth, ctype, _, _, interlace = _header(data, name)
    if interlace:
        raise ValueError(f"{name}: Adam7-interlaced PNG is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: unknown PNG colour type {ctype}")
    if depth != 8 and not (depth == 16 and ctype == 0):
        raise ValueError(f"{name}: {depth}-bit PNG of colour type {ctype} "
                         "is not supported (8 bits, or 16 for gray)")
    palette, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{name}: truncated image data")
    raw = raw[:height * (stride + 1)]
    rows = unfilter(raw, height, stride, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width)
    px = rows.reshape(height, width, channels)
    if ctype == 0:
        return px[..., 0]
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        return palette[px[..., 0]]
    if ctype == 4:
        return px[..., 0]
    return np.ascontiguousarray(px[..., :3])


def read_rgb(src) -> np.ndarray:
    """(H, W, 3) float32 RGB in 0..255, gray replicated (PIL's
    `convert("RGB")`), from a PNG or a JPEG."""
    data, name = read_bytes(src)
    if data[:3] == JPEG_SIGNATURE:
        return _read_jpeg(data, name)
    px = _decode_png(data, name)
    if px.dtype != np.uint8:
        raise ValueError(f"{src}: a 16-bit PNG is not an RGB image")
    if px.ndim == 2:
        px = np.repeat(px[..., None], 3, axis=-1)
    return px.astype(np.float32)


def _read_jpeg(data: bytes, name: str) -> np.ndarray:
    """The port's decoder (`utils.jpeg`); a file of a kind it refuses goes
    to PIL where PIL imports, else raises naming the file and the kind. A
    file it cannot read raises its ValueError on every machine."""
    from gedepth_tpu_torch.utils.jpeg import JpegRefused, decode_bytes

    try:
        return decode_bytes(data, name).astype(np.float32)
    except JpegRefused as err:
        try:
            import io

            from PIL import Image
        except ImportError:
            raise ImportError(f"{err}; PIL, which would, does not import "
                              "here") from err
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32)


def load_depth_png(path, depth_scale: float = 256.0) -> np.ndarray:
    """KITTI ground truth: a 16-bit gray PNG divided by depth_scale, float32
    (the port of `gedepth_tpu.utils.native.load_depth_png`)."""
    return read_png(path).astype(np.float32) / depth_scale


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, array: np.ndarray) -> None:
    """Write uint8 (H, W) gray or (H, W, 3) RGB, or uint16 (H, W) gray, with
    filter type 0 on every row (`encode_png`)."""
    body = encode_png(array)
    with open(path, "wb") as f:
        f.write(body)


def encode_png(array: np.ndarray) -> bytes:
    """The PNG file of uint8 (H, W) gray or (H, W, 3) RGB, or uint16 (H, W)
    gray, with filter type 0 on every row, as bytes."""
    a = np.asarray(array)
    if a.dtype == np.uint8 and a.ndim == 2:
        ctype, depth = 0, 8
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        ctype, depth = 2, 8
    elif a.dtype == np.uint16 and a.ndim == 2:
        ctype, depth = 0, 16
        a = a.astype(">u2")
    else:
        raise ValueError(f"write_png: uint8 (H, W[, 3]) or uint16 (H, W), "
                         f"got {a.dtype} {a.shape}")
    height, width = a.shape[:2]
    rows = np.ascontiguousarray(a).view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                          ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))
