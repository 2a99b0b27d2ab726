"""Tensor ops of the port. The three kernel-holding modules
(`window_attention`, `msda`, `pe_fusion`) each pair hand-written CUDA
kernels with their plain PyTorch versions behind dispatcher ops of the
namespace `gedepth_torch` (`_lib.define_op`, registered on import);
`_lib` builds and binds the kernels on first use."""
