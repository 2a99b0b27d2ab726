from gedepth_tpu_torch.configs.base import (  # noqa: F401
    DataConfig, ExperimentConfig, ModelConfig, OptimConfig, TrainConfig,
    apply_options, image_channels)
from gedepth_tpu_torch.configs.presets import get_config, list_configs  # noqa: F401
