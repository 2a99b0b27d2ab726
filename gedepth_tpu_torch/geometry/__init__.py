from gedepth_tpu_torch.geometry.calib import (  # noqa: F401
    DDAD_CAMERA_HEIGHTS, KITTI_CAM_INTRINSICS_3x3, KITTI_CAM_INTRINSICS_4COL,
    KITTI_CAMERA_HEIGHT, kitti_projection_matrix, parse_kitti_calib)
from gedepth_tpu_torch.geometry.plane import (  # noqa: F401
    NUM_SLOPE_BINS, SLOPE_BIN_CENTERS_DEG, SLOPE_IGNORE_INDEX,
    clip_pe_for_input, ddad_plane_embedding, kitti_plane_embedding,
    plane_embedding_from_projection, sanitize_pe_raw, slope_bin_gt,
    slope_gt_to_class, slope_to_pe_offset)
