from gedepth_tpu_torch.data.transforms import (  # noqa: F401
    Compose, KBCrop, Normalize, build_test_pipeline)
