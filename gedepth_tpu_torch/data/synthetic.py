"""A KITTI-shaped synthetic camera and request, for smoke runs and tests."""
from __future__ import annotations

import numpy as np

from gedepth_tpu_torch.geometry.plane import (
    plane_embedding_from_projection, sanitize_pe_raw)


def toy_projection(h, w):
    """(3, 4) projection of a forward-looking camera over flat ground, the
    camera of `gedepth_tpu.data.synthetic`."""
    fx = 0.6 * w
    K = np.array([[fx, 0, w / 2], [0, fx, 0.42 * h], [0, 0, 1.0]])
    R = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float64)
    return K @ np.concatenate([R, np.zeros((3, 1))], axis=1)


def synthetic_request(rng, height=375, width=1242, camera_height=1.65):
    """One raw request: an RGB image (0..255) and the finite raw PE of the
    toy camera, both (height, width[, 3]) float32."""
    pe = plane_embedding_from_projection(
        toy_projection(height, width), height, width, camera_height)
    rows = np.linspace(0, 1, height, dtype=np.float32)[:, None, None]
    rgb = 60 + 120 * rows + rng.normal(0, 25, (height, width, 3))
    return (np.clip(rgb, 0, 255).astype(np.float32), sanitize_pe_raw(pe))
