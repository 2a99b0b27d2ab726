"""Ground-plane ("plane embedding", PE) geometry used by the port.

The numpy pieces are the same functions as `gedepth_tpu.geometry.plane`;
`slope_to_pe_offset` takes torch tensors.
"""
from __future__ import annotations

import numpy as np

NUM_SLOPE_BINS = 11
SLOPE_IGNORE_INDEX = 255
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


def kitti_plane_embedding(A: np.ndarray, height: int, width: int,
                          camera_height: float = 1.65) -> np.ndarray:
    """KITTI PE: A = P2 @ R0_rect @ Tr_velo_to_cam, offset by the camera
    height."""
    return plane_embedding_from_projection(A, height, width, camera_height)


def ddad_plane_embedding(K: np.ndarray, cam_pose: np.ndarray,
                         lidar_pose: np.ndarray, height: int,
                         width: int) -> np.ndarray:
    """DDAD PE: A = K4 @ inv(cam_pose) @ lidar_pose with no height offset
    (the lidar pose holds it). K is the 3x3 intrinsics, the poses 4x4."""
    K4 = np.eye(4, dtype=np.float64)
    K4[:3, :3] = np.asarray(K, dtype=np.float64)
    A = K4 @ np.linalg.inv(np.asarray(cam_pose, dtype=np.float64)) @ \
        np.asarray(lidar_pose, dtype=np.float64)
    return plane_embedding_from_projection(A[:3, :4], height, width, 0.0)


def slope_bin_gt(gt_depth: np.ndarray, pe: np.ndarray,
                 camera_height: float = 1.65,
                 rounding: str = "round") -> np.ndarray:
    """Per-pixel ground-slope GT in signed degrees: tan(k) = h/gt − h/pe,
    binned by `rounding`, clipped to [−5, 5], SLOPE_IGNORE_INDEX where
    gt_depth == 0. Returns (H, W) float32.

    rounding 'round' is KITTI's rule (to the nearest degree, half to even);
    'trunc' is DDAD's (toward zero, an int64 cast): the NaNs of gt == 0 are
    set to 0 before the cast, which cannot take them, and become the ignore
    index after it."""
    gt = np.asarray(gt_depth, dtype=np.float64)
    pe = np.asarray(pe, dtype=np.float64)
    invalid = gt == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        k = camera_height / gt - camera_height / pe
    k = np.rad2deg(np.arctan(k))
    if rounding == "round":
        k = np.around(k)
    elif rounding == "trunc":
        k = np.where(invalid, 0.0, k).astype(np.int64).astype(np.float64)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    k = np.clip(k, -5, 5)
    return np.where(invalid, float(SLOPE_IGNORE_INDEX), k).astype(np.float32)


def slope_gt_to_class(k_img: np.ndarray) -> np.ndarray:
    """Slope GT in degrees (−5..5, 255 = ignore) to class ids 0..10: +5,
    and the shifted ignore value 260 back to 255."""
    k = np.asarray(k_img, dtype=np.float32) + 5.0
    return np.where(k == float(SLOPE_IGNORE_INDEX) + 5.0,
                    float(SLOPE_IGNORE_INDEX), k)


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
