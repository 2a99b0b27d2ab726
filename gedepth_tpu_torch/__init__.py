"""GEDepth in PyTorch and CUDA: the port of `gedepth_tpu` to NVIDIA Hopper.

The package mirrors `gedepth_tpu`'s tree (configs, geometry, data, ops,
models, convert, apis) and imports neither JAX nor `gedepth_tpu`. It serves
GEDepth-Adaptive Swin-L with the windowed deformable-attention neck
(`gedepth_adaptive_kitti_tpu`); its three hot ops (Swin window attention,
multi-level deformable sampling, adaptive PE fusion) are hand-written CUDA
kernels in `csrc/`, built by `nvcc` on first use (`ops/_lib.py`), each with
its plain PyTorch version beside it for CPU tensors.
"""
from gedepth_tpu_torch.configs import get_config, list_configs  # noqa: F401
