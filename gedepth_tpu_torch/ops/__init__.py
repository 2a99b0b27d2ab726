"""Tensor ops of the port. The three kernel-holding modules
(`window_attention`, `msda`, `pe_fusion`) each pair a hand-written CUDA
kernel with its plain PyTorch version; `_lib` builds and binds the kernels
on first use."""
