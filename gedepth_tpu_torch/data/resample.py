"""cv2's resampling rules, in torch CPU ops: the resizes and the rotation of
the JAX package's augmentations (`gedepth_tpu.data.transforms`, which calls
OpenCV 5) reproduced without OpenCV.

  resize_linear(x, (w, h))      cv2.resize(INTER_LINEAR), float32
  resize_nearest(x, (w, h))     cv2.resize(INTER_NEAREST)
  resize_area(x, (w, h))        cv2.resize(INTER_AREA), float32, downscale
  resize_area_u8(x, (w, h))     the same of uint8, rounded and saturated
  rotation_matrix(c, deg, s)    cv2.getRotationMatrix2D
  warp_affine(x, M, linear, b)  cv2.warpAffine(INTER_LINEAR | INTER_NEAREST,
                                BORDER_CONSTANT b), output size = input size

Arrays are numpy (H, W) or (H, W, C) in and out, any number of channels.
The rules, as OpenCV 5 applies them:

- Linear resize: source position (d + 0.5)·(src/dst) − 0.5 in float64,
  clamped to the border (weight 0 past either edge), no antialias; one
  horizontal pass, then one vertical, in float32.
- Nearest resize: source index floor(d · (1 / (dst/src))) in float64, capped
  at the last pixel (torch's legacy 'nearest', not 'nearest-exact').
- Area resize (downscale): each output pixel averages the source cells it
  covers, partial cells by their covered share (OpenCV's
  computeResizeAreaTab), horizontally then vertically in float32, rounded
  half to even and saturated to 0..255.
- warpAffine: M is inverted in float64 and cast to float32; the source
  position of output pixel (x, y) is fma(M0, x, fl(y·M1 + M2)) (and alike
  for the row) in float32, except in the last (width mod VECTOR_COLUMNS)
  columns of a row, which OpenCV's scalar loop computes as fma(x, M0, y·M1)
  + M2. Nearest rounds half to even; linear blends the four neighbours as
  v0 = p00 + fx·(p01 − p00), v1 = p10 + fx·(p11 − p10), then
  v0 + fy·(v1 − v0).
  A neighbour outside the image reads the border value.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# OpenCV's warpAffine kernel steps 16 float32 columns at a time (two AVX2
# vectors); the columns left over at the end of a row take its scalar path
VECTOR_COLUMNS = 16


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _linear_taps(src: int, dst: int):
    """(i0, i1, w0, w1) of a linear resize along one axis."""
    pos = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    low, high = i0 < 0, i0 >= src - 1
    i0[low], frac[low] = 0, 0.0
    i0[high], frac[high] = src - 1, 0.0
    i1 = np.minimum(i0 + 1, src - 1)
    return (_t(i0), _t(i1), _t((1.0 - frac).astype(np.float32)),
            _t(frac.astype(np.float32)))


def _lerp_axis(x, dim, taps):
    i0, i1, w0, w1 = taps
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x.index_select(dim, i0) * w0.view(shape)
            + x.index_select(dim, i1) * w1.view(shape))


def resize_linear(x: np.ndarray, size_wh) -> np.ndarray:
    """cv2.resize(x, size_wh, interpolation=INTER_LINEAR) of float32 x."""
    w, h = size_wh
    t = _t(np.asarray(x, np.float32))
    t = _lerp_axis(t, 1, _linear_taps(t.shape[1], w))
    return _lerp_axis(t, 0, _linear_taps(t.shape[0], h)).numpy()


def _nearest_index(src: int, dst: int):
    scale = 1.0 / (dst / src)
    return _t(np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                         src - 1))


def resize_nearest(x: np.ndarray, size_wh) -> np.ndarray:
    """cv2.resize(x, size_wh, interpolation=INTER_NEAREST)."""
    w, h = size_wh
    t = _t(x)
    t = t.index_select(1, _nearest_index(t.shape[1], w))
    return t.index_select(0, _nearest_index(t.shape[0], h)).numpy()


@functools.lru_cache(maxsize=16)
def _area_taps(src: int, dst: int):
    """(index, weight), each (dst, K): the source cells of each output pixel
    and the share each holds (OpenCV's computeResizeAreaTab); unused taps
    have weight 0."""
    scale = 1.0 / (dst / src)
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(math.floor(f2)), src - 1)
        s1 = min(int(math.ceil(f1)), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    index = np.zeros((dst, k), np.int64)
    weight = np.zeros((dst, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            index[d, j], weight[d, j] = s, a
    return _t(index), _t(weight)


def _area_axis(x, dim, src, dst):
    index, weight = _area_taps(src, dst)
    k = index.shape[1]
    shape = list(x.shape)
    shape[dim:dim + 1] = [dst, k]
    taps = x.index_select(dim, index.reshape(-1)).view(shape)
    wshape = [1] * x.dim()
    wshape[dim] = dst
    out = None
    for j in range(k):      # the taps in order, as OpenCV sums them
        term = taps.select(dim + 1, j) * weight[:, j].reshape(wshape)
        out = term if out is None else out + term
    return out


def resize_area(x: np.ndarray, size_wh) -> np.ndarray:
    """cv2.resize(x, size_wh, interpolation=INTER_AREA) of float32 x, for a
    downscale along both axes."""
    w, h = size_wh
    src_h, src_w = x.shape[:2]
    if w > src_w or h > src_h:
        raise ValueError(f"area resize downscales only: {x.shape[:2]} -> "
                         f"{(h, w)}")
    t = _t(np.asarray(x, np.float32))
    return _area_axis(_area_axis(t, 1, src_w, w), 0, src_h, h).numpy()


def resize_area_u8(x: np.ndarray, size_wh) -> np.ndarray:
    """cv2.resize(x, size_wh, interpolation=INTER_AREA) of uint8 x: the
    float32 average rounded half to even and saturated."""
    out = torch.from_numpy(resize_area(np.asarray(x, np.uint8), size_wh))
    return torch.round(out).clamp(0, 255).to(torch.uint8).numpy()


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, angle in degrees
    (counter-clockwise for a positive angle, the origin top left)."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(M):
    m = np.asarray(M, np.float64).reshape(6).copy()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0], m[1], m[3], m[4] = a11, -m[1] * det, -m[3] * det, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.astype(np.float32)


def _fma32(a, b, c):
    """float32 a·b + c with one rounding (the product of two float32 is
    exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _source_positions(M, h: int, w: int):
    """float32 (h, w) source x and y of every output pixel of warpAffine."""
    m = _invert_affine(M)
    f32 = np.float32
    x = np.arange(w, dtype=f32)[None, :]
    y = np.arange(h, dtype=f32)[:, None]
    sx = _fma32(np.full_like(x, m[0]), x, y * m[1] + m[2])
    sy = _fma32(np.full_like(x, m[3]), x, y * m[4] + m[5])
    tail = w - w % VECTOR_COLUMNS
    if tail < w:
        xt = np.broadcast_to(x[:, tail:], (h, w - tail))
        sx[:, tail:] = _fma32(xt, np.full_like(xt, m[0]), y * m[1]) + m[2]
        sy[:, tail:] = _fma32(xt, np.full_like(xt, m[3]), y * m[4]) + m[5]
    return sx, sy


def _padded(x, border):
    """x (H, W[, C]) as (H+2)·(W+2) rows of C, framed by the border value."""
    h, w = x.shape[:2]
    src = _t(np.asarray(x, np.float32)).reshape(h, w, -1)
    out = torch.full((h + 2, w + 2, src.shape[2]), float(border))
    out[1:-1, 1:-1] = src
    return out.view(-1, src.shape[2])


def _gather(src, w, iy, ix):
    """Rows of the framed `src` at (iy, ix), each clamped to [-1, size]:
    a position outside the image reads the frame."""
    return src.index_select(0, ((iy + 1) * (w + 2) + ix + 1).reshape(-1))


def warp_affine(x: np.ndarray, M, linear: bool, border: float = 0.0):
    """cv2.warpAffine(x, M, (W, H), flags=INTER_LINEAR if linear else
    INTER_NEAREST, borderValue=border) of float32 x."""
    h, w = x.shape[:2]
    sx, sy = (_t(a) for a in _source_positions(M, h, w))
    src = _padded(x, border)

    def ys(i):
        return i.clamp(-1, h)

    def xs(i):
        return i.clamp(-1, w)

    if not linear:
        out = _gather(src, w, ys(torch.round(sy).long()),
                      xs(torch.round(sx).long()))
        return out.reshape(x.shape).numpy()
    ix, iy = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - ix).view(-1, 1), (sy - iy).view(-1, 1)
    ix, iy = ix.long(), iy.long()
    x0, x1, y0, y1 = xs(ix), xs(ix + 1), ys(iy), ys(iy + 1)
    p00, p01 = _gather(src, w, y0, x0), _gather(src, w, y0, x1)
    p10, p11 = _gather(src, w, y1, x0), _gather(src, w, y1, x1)
    v0 = p00 + fx * (p01 - p00)
    v1 = p10 + fx * (p11 - p10)
    return (v0 + fy * (v1 - v0)).reshape(x.shape).numpy()
