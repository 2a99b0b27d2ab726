from gedepth_tpu_torch.geometry.plane import (  # noqa: F401
    NUM_SLOPE_BINS, SLOPE_BIN_CENTERS_DEG, SLOPE_IGNORE_INDEX,
    clip_pe_for_input, plane_embedding_from_projection, sanitize_pe_raw,
    slope_bin_gt, slope_gt_to_class, slope_to_pe_offset)
