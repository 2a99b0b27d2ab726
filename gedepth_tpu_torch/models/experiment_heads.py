"""The toolbox's experiment heads and ops (the port of
`gedepth_tpu.models.experiment_heads`; SURVEY.md §2.8): `GuidanceHead`,
pixel-adaptive convolution (`pixel_adaptive_conv`, `PacConv`; the
reference's pac.py), depth -> surface normals by central differences
(`depth_to_normals`) and the compact ASN-style `ASNDepthHead`. No preset
builds them, as in the JAX package.

Tensors at the interface are NHWC, as the JAX package's are (a head takes
its pyramid fine -> coarse, as `models.necks_extra.UpSampleChain`); the
convolutions run NCHW inside. Module names are the flax modules' (`conv0`,
`up{i}.convA`, `guide`, `pac`, `conv_depth`), each ConvModule with `conv`,
so that `convert.from_jax` carries a flax tree both ways. A head's input
widths default to its up_sample_channels (flax infers them).

Written as plain tensor ops: the JAX package runs them as XLA ops, not in
a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import ConvModule, conv2d, leaky_relu
from gedepth_tpu_torch.models.necks_extra import UpSampleChain


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class GuidanceHead(UpSampleChain):
    """DenseDepth-style decoder to one raw channel: relu + min_depth, or a
    sigmoid with use_sigmoid (reference guidance_head.py:27-110).
    forward(inputs NHWC fine -> coarse) -> (B, H, W, 1) at the finest
    level."""

    def __init__(self, up_sample_channels: Sequence[int],
                 in_channels: Optional[Sequence[int]] = None,
                 min_depth: float = 1e-3, use_sigmoid: bool = False):
        super().__init__(up_sample_channels, in_channels)
        self.min_depth = min_depth
        self.use_sigmoid = use_sigmoid
        self.conv_depth = conv2d(up_sample_channels[0], 1, 3, padding=1)

    def forward(self, inputs):
        g = self.conv_depth(super().forward([_nchw(x) for x in inputs]))
        g = torch.sigmoid(g) if self.use_sigmoid else (F.relu(g)
                                                       + self.min_depth)
        return _nhwc(g)


def pixel_adaptive_conv(x, guide, kernel, kernel_size: int = 3,
                        channel_wise: bool = False):
    """A k x k convolution whose taps are weighted per pixel by the
    Gaussian affinity of the guidance (Su et al. 2019):

      out[p] = sum_q K[p - q] · exp(-0.5 ||g_p - g_q||²) · x[q]

    x (B, H, W, C), guide (B, H, W, Cg), kernel (kh, kw, C, Cout) (flax's
    layout, read tap-major). Taps outside the image read zeros from x and
    from the zero-padded guide, whose affinity there is that of a zero
    vector, not 0 (pa_gaussian_kernel masks them; this does not, as the
    JAX package does not). channel_wise is unused, as in the JAX package.
    Returns (B, H, W, Cout)."""
    B, H, W, C = x.shape
    k = kernel_size
    pad = k // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    gp = F.pad(guide, (0, 0, pad, pad, pad, pad))
    taps, affs = [], []
    for dy in range(k):
        for dx in range(k):
            taps.append(xp[:, dy:dy + H, dx:dx + W, :])
            diff = gp[:, dy:dy + H, dx:dx + W, :] - guide
            affs.append(torch.exp(-0.5 * (diff * diff).sum(dim=-1)))
    weighted = torch.stack(taps, dim=3) * torch.stack(affs, dim=3)[..., None]
    return torch.einsum("bhwtc,tco->bhwo", weighted,
                        kernel.reshape(k * k, C, -1))


class PacConv(nn.Module):
    """`pixel_adaptive_conv` with a learned kernel and bias. The weight is
    stored as a convolution's, (Cout, C, k, k); forward(x, guide) NHWC."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.zeros(features, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def init_params(self, gen):
        """PyTorch's convolution default, U(±1/sqrt(fan_in)), and a zero
        bias (the JAX package's `torch_conv_kernel_init` and zeros)."""
        bound = 1.0 / math.sqrt(max(self.weight[0].numel(), 1))
        nn.init.uniform_(self.weight, -bound, bound, generator=gen)
        nn.init.zeros_(self.bias)

    def forward(self, x, guide):
        kernel = self.weight.permute(2, 3, 1, 0)       # (kh, kw, C, Cout)
        return pixel_adaptive_conv(x, guide, kernel,
                                   self.kernel_size) + self.bias


def depth_to_normals(depth, fx: float, fy: float):
    """Unit surface normals (B, H, W, 3) in camera coordinates from metric
    depth (B, H, W, 1) by central differences that wrap at the borders (the
    JAX package's `jnp.roll`; no padding), dz/dX = dz/du · fx / z."""
    d = depth[..., 0]
    dzdx = (torch.roll(d, -1, dims=2) - torch.roll(d, 1, dims=2)) * 0.5
    dzdy = (torch.roll(d, -1, dims=1) - torch.roll(d, 1, dims=1)) * 0.5
    z = torch.clamp_min(d, 1e-6)
    n = torch.stack([-dzdx * fx / z, -dzdy * fy / z, torch.ones_like(d)],
                    dim=-1)
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-12)


class ASNDepthHead(UpSampleChain):
    """The compact ASN-style head: DenseDepth's decoder, a 16-wide guidance
    ConvModule (LeakyReLU), a `PacConv` of `channels` guided by it, a 3x3
    depth conv, relu + min_depth, and the normals of that depth at focal
    length `focal`. forward(inputs NHWC fine -> coarse) -> (depth
    (B, H, W, 1), normals (B, H, W, 3)) at the finest level."""

    def __init__(self, up_sample_channels: Sequence[int],
                 in_channels: Optional[Sequence[int]] = None,
                 channels: int = 64, min_depth: float = 1e-3,
                 max_depth: float = 10.0, focal: float = 519.0):
        super().__init__(up_sample_channels, in_channels)
        width = up_sample_channels[0]
        self.min_depth, self.max_depth, self.focal = (min_depth, max_depth,
                                                      focal)
        self.guide = ConvModule(width, 16, 3, act=leaky_relu, use_bias=True)
        self.pac = PacConv(width, channels)
        self.conv_depth = conv2d(channels, 1, 3, padding=1)

    def forward(self, inputs):
        x = super().forward([_nchw(t) for t in inputs])
        x = self.pac(_nhwc(x), _nhwc(self.guide(x)))
        depth = _nhwc(F.relu(self.conv_depth(_nchw(x)))) + self.min_depth
        return depth, depth_to_normals(depth, self.focal, self.focal)
