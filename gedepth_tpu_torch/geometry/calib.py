"""Camera calibration for KITTI and DDAD (the port of
`gedepth_tpu.geometry.calib`, same values and functions).

KITTI: the raw `calib_cam_to_cam.txt` and `calib_velo_to_cam.txt` files
parsed into the velodyne-to-image projection A = P2 @ R0_rect @
Tr_velo_to_cam, and the per-date intrinsics that the datasets attach to a
sample as `cam_intrinsic`. DDAD: the ground height of each camera.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

KITTI_CAMERA_HEIGHT = 1.65

# Per-date 3x4 cam-2 intrinsic rows used as `cam_intrinsic` metadata.
KITTI_CAM_INTRINSICS_4COL = {
    "2011_09_26": [[7.215377e02, 0.0, 6.095593e02, 4.485728e01],
                   [0.0, 7.215377e02, 1.728540e02, 2.163791e-01],
                   [0.0, 0.0, 1.0, 2.745884e-03]],
    "2011_09_28": [[7.070493e02, 0.0, 6.040814e02, 4.575831e01],
                   [0.0, 7.070493e02, 1.805066e02, -3.454157e-01],
                   [0.0, 0.0, 1.0, 4.981016e-03]],
    "2011_09_29": [[7.183351e02, 0.0, 6.003891e02, 4.450382e01],
                   [0.0, 7.183351e02, 1.815122e02, -5.951107e-01],
                   [0.0, 0.0, 1.0, 2.616315e-03]],
    "2011_09_30": [[7.070912e02, 0.0, 6.018873e02, 4.688783e01],
                   [0.0, 7.070912e02, 1.831104e02, 1.178601e-01],
                   [0.0, 0.0, 1.0, 6.203223e-03]],
    "2011_10_03": [[7.188560e02, 0.0, 6.071928e02, 4.538225e01],
                   [0.0, 7.188560e02, 1.852157e02, -1.130887e-01],
                   [0.0, 0.0, 1.0, 3.779761e-03]],
}

KITTI_CAM_INTRINSICS_3x3 = {
    date: np.array([row[:3] for row in mat], dtype=np.float64)
    for date, mat in KITTI_CAM_INTRINSICS_4COL.items()
}

# Per-camera ground-plane heights for DDAD (meters).
DDAD_CAMERA_HEIGHTS = {
    "CAMERA_01": 1.56,
    "CAMERA_05": 1.57,
    "CAMERA_06": 1.53,
    "CAMERA_09": 1.53,
}


def _parse_calib_lines(lines):
    """Parse `key: v v v ...` lines into {key: np.array}."""
    out = {}
    for line in lines:
        line = line.strip()
        if not line or ":" not in line:
            continue
        key, _, vals = line.partition(":")
        try:
            out[key.strip()] = np.array(
                [float(x) for x in vals.split()], dtype=np.float64)
        except ValueError:
            continue  # non-numeric entries like calib_time
    return out


def parse_kitti_calib(calib_cam_to_cam_path: str,
                      calib_velo_to_cam_path: str) -> dict:
    """Parse KITTI calibration files.

    Returns dict with 'P2' (3,4), 'R0_rect' (4,4 homogeneous),
    'Tr_velo_to_cam' (4,4 homogeneous) and the combined 'A' (3,4).
    """
    with open(calib_cam_to_cam_path) as f:
        cam = _parse_calib_lines(f.readlines())
    with open(calib_velo_to_cam_path) as f:
        velo = _parse_calib_lines(f.readlines())

    P2 = cam["P_rect_02"].reshape(3, 4)
    R0 = np.eye(4, dtype=np.float64)
    R0[:3, :3] = cam["R_rect_00"].reshape(3, 3)
    Tr = np.eye(4, dtype=np.float64)
    Tr[:3, :3] = velo["R"].reshape(3, 3)
    Tr[:3, 3] = velo["T"].reshape(3)

    P2h = np.zeros((3, 4), dtype=np.float64)
    P2h[:, :] = P2
    A = P2 @ R0 @ Tr  # (3,4) @ (4,4) @ (4,4) -> (3,4)
    return {"P2": P2, "R0_rect": R0, "Tr_velo_to_cam": Tr, "A": A, "P2h": P2h}


def kitti_projection_matrix(calib_dir: str) -> np.ndarray:
    """Combined (3,4) velodyne->image projection for a KITTI date directory."""
    return parse_kitti_calib(
        osp.join(calib_dir, "calib_cam_to_cam.txt"),
        osp.join(calib_dir, "calib_velo_to_cam.txt"))["A"]
