"""The port's PNG reader and writer (`gedepth_tpu_torch.utils.png`) against
PIL and cv2, on the CPU.

Files written by PIL and by cv2, and PNGs built here byte by byte with
every scanline filter, every colour type the data path reads and several
IDAT chunks, decode to exactly PIL's array (`convert("RGB")` for palette
and RGBA files). The C++ unfilter equals the numpy one bit for bit; an
interlaced file is refused; `write_png` round-trips through PIL. All
comparisons are exact: PNG is lossless.
"""
import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from gedepth_tpu_torch.utils import png


def _read_plain(data, monkeypatch):
    """read_png with the numpy reference unfilter in place of the C++
    loop."""
    with monkeypatch.context() as m:
        m.setattr(png, "unfilter", png.unfilter_plain)
        return png.read_png(data)


def _pil_bytes(array, mode=None, **save):
    buf = io.BytesIO()
    Image.fromarray(array, mode).save(buf, format="PNG", **save) \
        if mode else Image.fromarray(array).save(buf, format="PNG", **save)
    return buf.getvalue()


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("kind", ["rgb", "gray", "gray16", "palette",
                                  "rgba"])
def test_read_png_matches_pil(kind, monkeypatch):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    if kind == "rgb":
        data = _pil_bytes(rgb)
        want = rgb
    elif kind == "gray":
        data = _pil_bytes(rgb[..., 0])
        want = rgb[..., 0]
    elif kind == "gray16":
        want = rng.integers(0, 65536, (37, 53)).astype(np.uint16)
        data = _pil_bytes(want)
    elif kind == "palette":
        buf = io.BytesIO()
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(
            buf, format="PNG")
        data = buf.getvalue()
        want = _pil_rgb(data)
    else:
        rgba = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
        data = _pil_bytes(rgba)
        want = _pil_rgb(data)
    got = png.read_png(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_read_plain(data, monkeypatch), want)
    if kind != "gray16":
        np.testing.assert_array_equal(png.read_rgb(data), _pil_rgb(data))


@pytest.mark.parametrize("depth", [8, 16])
def test_read_png_matches_cv2_files(tmp_path, depth):
    rng = np.random.default_rng(1)
    if depth == 8:
        want = rng.integers(0, 256, (41, 67, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / "a.png"), want[..., ::-1])
    else:
        want = rng.integers(0, 65536, (41, 67)).astype(np.uint16)
        cv2.imwrite(str(tmp_path / "a.png"), want)
    np.testing.assert_array_equal(png.read_png(tmp_path / "a.png"), want)
    assert png.png_size(tmp_path / "a.png") == (41, 67)


def _filtered_rows(rows, bpp, kinds):
    """PNG scanlines of `rows` (H, stride uint8) filtered by kinds[y]."""
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = kinds[y % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, up_left))
        out.append(bytes([kind]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prior = row
    return b"".join(out)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _hand_png(pixels, ctype, depth, kinds, n_idat=3, palette=None,
              interlace=0):
    h, w = pixels.shape[:2]
    if depth == 16:
        rows = pixels.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        rows = pixels.reshape(h, -1)
    bpp = max(rows.shape[1] // w, 1)
    data = zlib.compress(_filtered_rows(rows, bpp, kinds))
    cut = np.linspace(0, len(data), n_idat + 1).astype(int)
    body = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    for a, b in zip(cut[:-1], cut[1:]):
        body += _chunk(b"IDAT", data[a:b])
    return body + _chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype,depth", [(0, 8), (0, 16), (2, 8), (3, 8),
                                         (6, 8)])
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (0, 1, 2, 3, 4)])
def test_hand_built_png_every_filter(ctype, depth, kinds, monkeypatch):
    """Every filter type alone and all five row by row, in three IDAT
    chunks: the port's array equals PIL's."""
    rng = np.random.default_rng(2)
    h, w = 9, 13
    palette = None
    if ctype == 0:
        pixels = rng.integers(0, 2 ** depth, (h, w)).astype(
            np.uint16 if depth == 16 else np.uint8)
    elif ctype == 3:
        palette = rng.integers(0, 256, (7, 3), dtype=np.uint8)
        pixels = rng.integers(0, 7, (h, w), dtype=np.uint8)
    else:
        pixels = rng.integers(0, 256, (h, w, 3 if ctype == 2 else 4),
                              dtype=np.uint8)
    data = _hand_png(pixels, ctype, depth, kinds, palette=palette)
    pil = Image.open(io.BytesIO(data))
    want = np.asarray(pil.convert("RGB")) if ctype in (3, 6) \
        else np.asarray(pil)
    got = png.read_png(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_read_plain(data, monkeypatch), want)


def test_cpp_unfilter_equals_numpy():
    rng = np.random.default_rng(3)
    for bpp, stride in ((1, 57), (2, 58), (3, 93), (4, 124)):
        height = 23
        raw = rng.integers(0, 256, (height, stride + 1), dtype=np.uint8)
        raw[:, 0] = rng.integers(0, 5, height)
        data = raw.tobytes()
        np.testing.assert_array_equal(
            png.unfilter(data, height, stride, bpp),
            png.unfilter_plain(data, height, stride, bpp))
    raw[5, 0] = 9
    with pytest.raises(ValueError, match="row 5"):
        png.unfilter(raw.tobytes(), height, stride, 4)
    with pytest.raises(ValueError, match="cannot hold"):
        png.unfilter(raw.tobytes()[:-1], height, stride, 4)


def test_interlaced_and_unsupported_refused(tmp_path):
    pixels = np.zeros((4, 5, 3), np.uint8)
    path = tmp_path / "adam7.png"
    path.write_bytes(_hand_png(pixels, 2, 8, (0,), interlace=1))
    with pytest.raises(ValueError, match="adam7.png.*interlaced"):
        png.read_png(path)
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png(_hand_png(np.zeros((3, 4, 3), np.uint16), 2, 16, (0,)))


@pytest.mark.parametrize("kind", ["gray", "rgb", "gray16"])
def test_write_png_round_trip(tmp_path, kind):
    rng = np.random.default_rng(4)
    a = {"gray": rng.integers(0, 256, (19, 31), dtype=np.uint8),
         "rgb": rng.integers(0, 256, (19, 31, 3), dtype=np.uint8),
         "gray16": rng.integers(0, 65536, (19, 31)).astype(np.uint16)}[kind]
    path = tmp_path / "w.png"
    png.write_png(path, a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
    np.testing.assert_array_equal(png.read_png(path), a)
    if kind == "gray16":
        np.testing.assert_array_equal(png.load_depth_png(path, 256.0),
                                      a.astype(np.float32) / 256.0)
    with pytest.raises(ValueError):
        png.write_png(path, a.astype(np.float32))
