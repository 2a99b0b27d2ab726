"""The port's JPEG decoder (`utils.jpeg`, `csrc/jpeg_decode.cpp`) against
PIL's libjpeg, on the CPU, bit for bit: seeded frames encoded here by PIL
at quality 50, 75 and 95, sampled 4:4:4, 4:2:2 and 4:2:0, gray, with
optimised Huffman tables and a restart interval, at sizes that are not
multiples of 16 (and chroma planes of 1 and 2 columns, which libjpeg-turbo
replicates instead of filtering); the committed fixtures against their
SHA-256 in `fixtures.json`; the refusals by name (progressive, CMYK) with
PIL made to fail at import, and `read_rgb`'s route: a baseline file never
reaches PIL, a refused one goes to PIL where it imports, a corrupt one
raises the decoder's error whether PIL imports or not.
"""
import hashlib
import io
import itertools
import json
import os
import os.path as osp
import sys

import numpy as np
import pytest

from gedepth_tpu_torch.tools.make_jpeg_fixtures import (
    DEFAULT_DIR, FIXTURES, synthetic_frame)
from gedepth_tpu_torch.utils.jpeg import (
    JpegRefused, decode_bytes, decode_jpeg, jpeg_size)
from gedepth_tpu_torch.utils.png import read_rgb

Image = pytest.importorskip("PIL.Image")

SIZES = ((45, 61), (33, 17), (64, 48))


def _encode(px, **options):
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", **options)
    return buf.getvalue()


def _pil(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _noisy(h, w, seed):
    """A frame with strong noise: many non-zero coefficients and clipped
    colours."""
    rng = np.random.default_rng(seed)
    if min(h, w) < 16:          # too small for the frame's blocks
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    px = synthetic_frame(h, w, seed).astype(np.float64)
    return np.clip(px + rng.normal(0, 25, px.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality,subsampling", itertools.product(
    (50, 75, 95), (0, 1, 2)))
def test_baseline_equals_pil(quality, subsampling):
    """4:4:4, 4:2:2 and 4:2:0 at three qualities and three sizes, smooth
    and noisy frames: every pixel equal to PIL's."""
    for (h, w), make in itertools.product(SIZES, (synthetic_frame, _noisy)):
        data = _encode(make(h, w, quality + subsampling), quality=quality,
                       subsampling=subsampling)
        got = decode_bytes(data)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("quality", (50, 75, 95))
def test_gray_replicated_as_pil_converts(quality):
    for h, w in SIZES:
        data = _encode(_noisy(h, w, quality)[..., 1], quality=quality)
        got = decode_bytes(data)
        assert (got[..., 0] == got[..., 2]).all()
        np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("options", [
    dict(optimize=True), dict(restart_marker_blocks=3),
    dict(restart_marker_rows=1, optimize=True), dict(quality=100)],
    ids=["optimized", "restart_blocks", "restart_rows_optimized", "q100"])
def test_tables_and_restarts_equal_pil(options):
    for subsampling, (h, w) in itertools.product((0, 1, 2), SIZES):
        data = _encode(_noisy(h, w, subsampling), subsampling=subsampling,
                       **options)
        np.testing.assert_array_equal(decode_bytes(data), _pil(data))


def test_narrow_chroma_planes_equal_pil():
    """Frames of 1 to 5 columns or rows: chroma planes of 1 and 2 columns
    are replicated (libjpeg-turbo filters from 3 on)."""
    for (h, w), subsampling in itertools.product(
            ((1, 1), (2, 3), (3, 2), (5, 4), (1, 4), (4, 1), (7, 5)),
            (1, 2)):
        data = _encode(_noisy(h, w, h * w), subsampling=subsampling)
        np.testing.assert_array_equal(decode_bytes(data), _pil(data))


def test_full_size_frame_equals_pil():
    """A 530x730 4:2:0 frame (SUN RGB-D's size) at quality 90."""
    data = _encode(_noisy(530, 730, 7), quality=90)
    assert jpeg_size(data) == (530, 730)
    np.testing.assert_array_equal(decode_bytes(data), _pil(data))


def test_fixtures_match_their_hashes():
    """Every committed fixture: the port's pixels hash to the SHA-256 in
    fixtures.json, which is PIL's, or the port refuses it by the kind the
    JSON names; together at most 1 MB."""
    with open(osp.join(DEFAULT_DIR, "fixtures.json")) as f:
        index = json.load(f)
    assert sorted(index) == sorted(FIXTURES)
    total = 0
    for name, entry in index.items():
        path = osp.join(DEFAULT_DIR, name)
        total += os.path.getsize(path)
        with Image.open(path) as im:
            pil = np.ascontiguousarray(np.asarray(im.convert("RGB")))
        assert hashlib.sha256(pil.tobytes()).hexdigest() == entry["sha256"]
        assert list(pil.shape) == entry["shape"]
        if entry["refused"]:
            with pytest.raises(JpegRefused) as err:
                decode_jpeg(path)
            assert err.value.kind == entry["refused"]
            continue
        got = decode_jpeg(path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    assert total <= 1 << 20


@pytest.fixture
def no_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_baseline_never_reaches_pil(no_pil, tmp_path):
    """With PIL's import made to fail, `read_rgb` reads every baseline
    fixture (also under another name) as float32 PIL pixels."""
    with open(osp.join(DEFAULT_DIR, "fixtures.json")) as f:
        index = json.load(f)
    for name, entry in index.items():
        if entry["refused"]:
            continue
        path = tmp_path / (name + ".png")         # the magic bytes decide
        path.write_bytes(open(osp.join(DEFAULT_DIR, name), "rb").read())
        got = read_rgb(str(path))
        assert got.dtype == np.float32
        assert hashlib.sha256(got.astype(np.uint8).tobytes()).hexdigest() \
            == entry["sha256"]


@pytest.mark.parametrize("name,kind", [("progressive.jpg", "progressive"),
                                       ("cmyk.jpg", "CMYK")])
def test_refused_kinds_named_without_pil(name, kind, no_pil):
    path = osp.join(DEFAULT_DIR, name)
    with pytest.raises(ImportError, match=f"{name}: a {kind} JPEG.*PIL"):
        read_rgb(path)


@pytest.mark.parametrize("name", ["progressive.jpg", "cmyk.jpg"])
def test_refused_kinds_go_to_pil(name):
    path = osp.join(DEFAULT_DIR, name)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"), np.float32)
    np.testing.assert_array_equal(read_rgb(path), want)


def test_refusals_by_kind():
    """A progressive file and a 4:4:0 one (luma sampled 1x2): JpegRefused
    naming the kind, from the frame header already (`jpeg_size`)."""
    px = synthetic_frame(32, 48, 0)
    data = _encode(px, progressive=True)
    for fn in (jpeg_size, decode_bytes):
        with pytest.raises(JpegRefused, match="progressive"):
            fn(data)
    data = bytearray(_encode(px, subsampling=0))
    sof = data.index(b"\xff\xc0")
    assert data[sof + 11] == 0x11          # luma h=1, v=1
    data[sof + 11] = 0x12
    with pytest.raises(JpegRefused, match="sampling 1x2,1x1,1x1"):
        decode_bytes(bytes(data))


def test_corrupt_named_without_pil(tmp_path, monkeypatch):
    data = _encode(synthetic_frame(32, 48, 1))
    monkeypatch.setitem(sys.modules, "PIL", None)
    path = tmp_path / "frame.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="frame.jpg: not a readable JPEG"):
        read_rgb(str(path))
    path.write_bytes(data[:len(data) // 3])       # truncated inside the scan
    with pytest.raises(ValueError, match="frame.jpg"):
        read_rgb(str(path))
    bad = bytearray(data)                 # more 1-bit codes than there are
    bad[bad.index(b"\xff\xc4") + 5] = 200
    path.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="bad Huffman table"):
        read_rgb(str(path))


def test_corrupt_never_reaches_pil(tmp_path, monkeypatch):
    """Where PIL imports, a file the decoder cannot read still raises the
    decoder's error naming the file: only a refused kind goes to PIL, so
    this machine and one without PIL answer alike."""
    def not_reached(*args, **kwargs):
        raise AssertionError("a corrupt JPEG reached PIL")

    monkeypatch.setattr(Image, "open", not_reached)
    path = tmp_path / "frame.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="frame.jpg: not a readable JPEG"):
        read_rgb(str(path))
