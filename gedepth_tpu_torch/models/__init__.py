from gedepth_tpu_torch.models.depther import GEDepth  # noqa: F401
