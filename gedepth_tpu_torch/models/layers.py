"""Common building blocks (NCHW inside, as PyTorch convolutions want).

Initialisation follows the JAX package's scheme: trunc-normal(0.02) linears
in the transformer, xavier-uniform in the necks and deformable attention,
PyTorch-default U(±1/sqrt(fan_in)) convolutions elsewhere. Each `nn.Linear`
or `nn.Conv2d` names its scheme in an `init` attribute; modules with other
parameters give an `init_params(generator)` method. `init_weights` applies
them all from one explicit `torch.Generator`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(in_features, out_features, bias=True, init="trunc_normal"):
    m = nn.Linear(in_features, out_features, bias=bias)
    m.init = init
    return m


def conv2d(in_ch, out_ch, kernel_size, stride=1, padding=0, bias=True,
           init="torch"):
    m = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                  bias=bias)
    m.init = init
    return m


def _init_affine(m, scheme, gen):
    w = m.weight
    fan_in = w[0].numel()
    if scheme == "torch":
        bound = 1.0 / math.sqrt(max(fan_in, 1))
        nn.init.uniform_(w, -bound, bound, generator=gen)
        if m.bias is not None:
            nn.init.uniform_(m.bias, -bound, bound, generator=gen)
        return
    if scheme == "trunc_normal":
        nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=gen)
    elif scheme == "xavier":
        nn.init.xavier_uniform_(w, generator=gen)
    elif scheme == "lecun":
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=gen)
    elif scheme == "zeros":
        nn.init.zeros_(w)
    else:
        raise ValueError(f"unknown init scheme {scheme!r}")
    if m.bias is not None:
        nn.init.zeros_(m.bias)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Initialise every parameter and statistic of `module` in place.
    Layers first, then the `init_params` of their owners, which may
    overwrite a layer's default (e.g. the deformable offset bias)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _init_affine(m, getattr(m, "init", "torch"), generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    for m in module.modules():
        if hasattr(m, "init_params"):
            m.init_params(generator)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm as the JAX package trains it (flax `nn.BatchNorm`,
    momentum 0.9, eps 1e-5), under torch's keys (`weight`, `bias`,
    `running_mean`, `running_var`, `num_batches_tracked`).

    In training it normalises with the biased batch variance, as torch does,
    but updates `running_var` with that same biased variance, as flax does;
    torch's own BatchNorm would store the unbiased one, n/(n−1) larger. This
    follows the JAX package, not torch's BatchNorm. Eval mode is torch's."""

    def __init__(self, num_features):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            # f32 statistics of a bf16 activation, as flax computes them;
            # the running buffers keep their own (f32) dtype
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            var, mean = (var.to(self.running_var.dtype),
                         mean.to(self.running_mean.dtype))
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


class ConvModule(nn.Module):
    """conv -> (BN) -> (act), the mmcv ConvModule shape; children `conv`
    and `bn` carry the reference parameter names. BN eps 1e-5; the flax
    momentum 0.9 is PyTorch's 0.1."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=None,
                 use_norm=False, act=None, use_bias=None, init="torch"):
        super().__init__()
        pad = kernel_size // 2 if padding is None else padding
        use_bias = (not use_norm) if use_bias is None else use_bias
        self.conv = conv2d(in_ch, out_ch, kernel_size, stride, pad,
                           bias=use_bias, init=init)
        self.bn = BatchNorm2d(out_ch) if use_norm else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class Stochastic(nn.Module):
    """A layer that draws random numbers in training, from the
    `torch.Generator` in `self.generator` (set by `GEDepth.set_generator`);
    it raises rather than touch the global generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def _uniform(self, shape, device):
        if self.generator is None:
            raise RuntimeError(
                f"{type(self).__name__}(rate={self.rate}) in training needs "
                "an explicit torch.Generator (GEDepth.set_generator)")
        return torch.rand(shape, generator=self.generator, device=device)

    def _keep(self, x, shape):
        """x / keep where a uniform draw of `shape` falls under keep, else
        0; divides in f32 and returns x's dtype."""
        keep = 1.0 - self.rate
        mask = self._uniform(shape, x.device) < keep
        return torch.where(mask, x.float() / keep, 0.0).to(x.dtype)


class DropPath(Stochastic):
    """Stochastic depth: drops the residual branch per sample in training;
    identity in eval mode."""

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        return self._keep(x, (x.shape[0],) + (1,) * (x.dim() - 1))


class Dropout(Stochastic):
    """Element-wise dropout in training (flax `nn.Dropout`: x / keep where
    kept); identity in eval mode."""

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        return self._keep(x, x.shape)


class FFN(nn.Module):
    """Transformer FFN Linear -> GELU (exact) -> Linear, laid out as mmcv's
    FFN so the keys read `ffn.layers.0.0` and `ffn.layers.1` (the JAX
    package's `Mlp` at drop_rate 0, which has no dropout)."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(linear(dim, hidden), nn.GELU(approximate="none")),
            linear(hidden, dim))

    def forward(self, x):
        return self.layers(x)


def sine_positional_encoding(h: int, w: int, num_feats: int = 256,
                             temperature: float = 10000.0, device=None):
    """DETR-style sine encoding over an (h, w) grid with 1-based cumsum
    coordinates (mmcv SinePositionalEncoding, normalize=False, all-valid
    mask). Returns (h, w, 2·num_feats) f32; a bf16 caller casts it to its
    query's dtype."""
    dim_t = np.arange(num_feats, dtype=np.float32)
    dim_t = torch.as_tensor(temperature ** (2 * (dim_t // 2) / num_feats),
                            device=device)
    y_embed = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x_embed = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    pos_x = x_embed[:, None] / dim_t                  # (w, F)
    pos_y = y_embed[:, None] / dim_t                  # (h, F)
    pos_x = torch.stack([pos_x[:, 0::2].sin(), pos_x[:, 1::2].cos()],
                        dim=2).reshape(w, num_feats)
    pos_y = torch.stack([pos_y[:, 0::2].sin(), pos_y[:, 1::2].cos()],
                        dim=2).reshape(h, num_feats)
    return torch.cat([pos_y[:, None, :].expand(h, w, num_feats),
                      pos_x[None, :, :].expand(h, w, num_feats)], dim=2)


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=0.01)
