"""GEDepth in PyTorch and CUDA: the port of `gedepth_tpu` to NVIDIA Hopper.

The package mirrors `gedepth_tpu`'s tree (configs, geometry, data, core,
ops, models, convert, apis, train, eval, tools) and imports neither JAX nor
`gedepth_tpu`. It serves, trains and evaluates GEDepth on Swin-L, f32: the
adaptive model with the exact (mmcv), nearest, windowed and windowed-compat
deformable-attention necks, GEDepth-Vanilla and the DepthFormer baseline
(`configs/presets.py`), on KITTI and DDAD trees read and augmented without
PIL or cv2 (`utils/png.py`, `data/resample.py`) or on synthetic frames;
it checkpoints and resumes training, reads and
writes the JAX package's params-only `.npz` (`train/checkpoint.py`) and
reads reference `.pth` files (`convert/from_pth.py`). Its hot ops (Swin
window attention, multi-level deformable sampling forward and backward,
adaptive PE fusion) are
hand-written CUDA kernels in `csrc/`, built by `nvcc` on first use
(`ops/_lib.py`), each with its plain PyTorch version beside it for CPU
tensors; every sampling mode runs through the same pair of sampling
kernels.
"""
from gedepth_tpu_torch.configs import get_config, list_configs  # noqa: F401
