"""Ground-plane ("plane embedding", PE) geometry used by the serving path.

The numpy pieces are the same functions as `gedepth_tpu.geometry.plane`;
`slope_to_pe_offset` takes torch tensors.
"""
from __future__ import annotations

import numpy as np

NUM_SLOPE_BINS = 11
# Bin centers in degrees: -5, -4, ..., +5.
SLOPE_BIN_CENTERS_DEG = np.linspace(
    -5.0, 5.0, NUM_SLOPE_BINS).astype(np.float32)


def plane_embedding_from_projection(A: np.ndarray, height: int, width: int,
                                    camera_height: float = 0.0) -> np.ndarray:
    """Analytic ground-plane depth of every pixel of a (height, width) image.

    A is the (3, 4) projection from world/lidar points to image coordinates.
    Returns (height, width) float64; values above the horizon are negative or
    huge, and callers clip (see `sanitize_pe_raw`, `clip_pe_for_input`).
    """
    A = np.asarray(A, dtype=np.float64)
    R_inv = np.linalg.inv(A[:3, :3])
    RT = R_inv @ A[:3, 3]
    u, v = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    denom = R_inv[2, 0] * u + R_inv[2, 1] * v + R_inv[2, 2]
    return (RT[2] - camera_height) / denom


def slope_to_pe_offset(pe_comput, slope_tan, camera_height, depth_scale):
    """Re-derive the plane prior from a (possibly soft) predicted slope.

      a = -h / (pe + 1e-8)
      offset = -h / (a - tan_k + 1e-8), zeroed outside (0, depth_scale].

    Returns (offset, valid) with valid the 0/1 mask in offset's dtype.
    """
    a = -camera_height / (pe_comput + 1e-8)
    offset = -camera_height / ((a - slope_tan) + 1e-8)
    valid = ((offset > 0) & (offset <= depth_scale)).to(offset.dtype)
    return offset * valid, valid


def sanitize_pe_raw(pe: np.ndarray, bound: float = 1e6) -> np.ndarray:
    """Finite raw plane embedding: +-inf on the horizon line and anything
    beyond +-bound clamp to +-bound, NaN becomes 0. Both lie far outside the
    (0, depth_scale] validity window, so the offset math is unchanged."""
    pe = np.asarray(pe, dtype=np.float32)
    return np.nan_to_num(pe, nan=0.0, posinf=bound, neginf=-bound).clip(
        -bound, bound)


def clip_pe_for_input(pe: np.ndarray, max_value: float = 200.0) -> np.ndarray:
    """Input-channel PE: values above max_value or below 0 become 0."""
    pe = np.asarray(pe, dtype=np.float32).copy()
    pe[pe > max_value] = 0
    pe[pe < 0] = 0
    return pe
