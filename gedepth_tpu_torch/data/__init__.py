from gedepth_tpu_torch.data.transforms import (  # noqa: F401
    IMAGENET_MEAN, IMAGENET_STD, ColorAug, Compose, DDADResize, KBCrop,
    Normalize, NYUCrop, PadToSize, RandomCrop, RandomFlip,
    RandomRatioResize, RandomRotate, build_test_pipeline,
    build_train_pipeline)
from gedepth_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticGroundDataset)
from gedepth_tpu_torch.data.kitti import KittiDataset  # noqa: F401
from gedepth_tpu_torch.data.ddad import DDADDataset  # noqa: F401
from gedepth_tpu_torch.data.nyu import NYUDataset  # noqa: F401
from gedepth_tpu_torch.data.extra_datasets import (  # noqa: F401
    CityscapesDataset, CustomDepthDataset, NuScenesDataset, SUNRGBDDataset)
from gedepth_tpu_torch.data.wrappers import (  # noqa: F401
    ConcatDataset, RepeatDataset)
from gedepth_tpu_torch.data.loader import EvalLoader, TrainLoader  # noqa: F401
