from gedepth_tpu_torch.data.transforms import (  # noqa: F401
    ColorAug, Compose, KBCrop, Normalize, RandomCrop, RandomFlip,
    build_test_pipeline, build_train_pipeline)
