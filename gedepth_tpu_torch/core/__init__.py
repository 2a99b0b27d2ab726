from gedepth_tpu_torch.core.metrics import (  # noqa: F401
    METRIC_NAMES, aggregate_metrics, batched_masked_metrics,
    calculate_metrics, eigen_crop_mask, eval_crop_mask, eval_kb_crop,
    garg_crop_mask, masked_metrics)
