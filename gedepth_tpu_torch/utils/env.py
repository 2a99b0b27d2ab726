"""The environment a run saw, logged first by the train loop (the port of
`gedepth_tpu.utils.env`, without its JAX part), and the precision switch of
the command-line tools."""
from __future__ import annotations

import platform
import subprocess
import sys

import torch


def collect_env() -> dict:
    """Python, platform, torch, its CUDA, numpy and, when there is a card,
    its name and power limit as nvidia-smi reports them."""
    import numpy

    info = {"python": sys.version.replace("\n", " "),
            "platform": platform.platform(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "numpy": numpy.__version__}
    if torch.cuda.is_available():
        info["device"] = torch.cuda.get_device_name(0)
        info["device_count"] = torch.cuda.device_count()
        try:
            info["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30, check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            info["nvidia_smi"] = f"unavailable: {e}"
    return info


def disable_tf32():
    """f32 means f32: matmuls and cuDNN convolutions without TF32.

    PyTorch lets cuDNN run f32 convolutions in TF32 by default, which moves
    a depth ~1e-3 away from the JAX package's f32. The command-line tools
    call this at start; the library functions (`init_depther`, `train`,
    `Evaluator`) leave these process-wide flags to their caller."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
