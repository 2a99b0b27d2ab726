"""The adaptive-surface-normal head `ASNDepthHeadV2` and its pieces (the
port of `gedepth_tpu.models.asn`; the reference's asn_depth_head.py and
pac.py). No preset builds it, as in the JAX package.

  select_triangles           triangle triplets of a k x k window, drawn
                             once from an explicit np.random.Generator
                             (the JAX package's draws, in its order)
  unfold_patches             torch's Unfold on NHWC: (B, H, W, k·k, C)
  pa_gaussian_kernel         packernel2d's normalised Gaussian affinity,
                             out-of-image taps masked
  asn_guide_weight           DepthNormalConversion's smoothed kernel
  adaptive_depth_to_normals  normals of the sampled triangles of each
                             pixel's window, mixed by a softmax over
                             validity x area x guidance
  depth_normal_conversion    both of the last two
  ASNSegHead                 3 x (conv-BN-ReLU), a sigmoid 1x1 per key,
                             bilinear x scale_factor (align_corners=True)
  disp_to_depth, ASNDepthHeadV2, asn_losses

Tensors at the interface are NHWC, as the JAX package's are; the
convolutions run NCHW inside. Module names are the flax modules'
(`depth_head`, `guidance_head`, `fuse{i}`, `bn{i}`, `cls_{key}`), so
that `convert.from_jax` carries a flax tree both ways; BatchNorm is flax's
(momentum 0.9, eps 1e-5: `layers.BatchNorm2d`). The normals are computed
in float32, as the JAX package computes them, or in float64 for float64
inputs. Plain tensor ops: the JAX package runs them as XLA ops, not in a
Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import BatchNorm2d, conv2d
from gedepth_tpu_torch.models.losses import sigloss
from gedepth_tpu_torch.models.losses_extra import (
    cosine_similarity_loss, edge_aware_smoothness_loss)
from gedepth_tpu_torch.ops.resize import resize_bilinear


def select_triangles(k_size: int = 3, sample_num: int = 40,
                     rng: Optional[np.random.Generator] = None,
                     area_type: int = 1, area_thred: float = 0.0):
    """(triplets (n, 3) int32, area weights (n,) float32): `sample_num`
    triplets of window indices drawn with replacement (three `choice`
    columns, each shuffled), each sorted; duplicates and triangles of area
    at most k²/2 · area_thred dropped; every kept triangle oriented
    positively; weights area^area_type, normalised to sum 1. The same
    generator state gives the JAX package's table."""
    rng = rng or np.random.default_rng(0)
    num = k_size * k_size
    thred = (k_size ** 2 * 0.5) * area_thred
    cols = []
    for _ in range(3):
        p = rng.choice(num, int(sample_num), replace=True)
        rng.shuffle(p)
        cols.append(p)
    valid, seen, areas = [], set(), []
    for row in np.stack(cols, axis=1):
        p1, p2, p3 = np.sort(row)
        if (p1, p2, p3) in seen:
            continue
        x1, y1 = p1 % k_size, p1 // k_size
        x2, y2 = p2 % k_size, p2 // k_size
        x3, y3 = p3 % k_size, p3 // k_size
        area = (x2 - x1) * (y3 - y1) - (y2 - y1) * (x3 - x1)
        if area > thred:
            valid.append([p1, p2, p3])
            seen.add((p1, p2, p3))
            areas.append(area)
        elif area < -thred:
            valid.append([p1, p3, p2])
            seen.add((p1, p3, p2))
            areas.append(-area)
    if not valid:
        raise ValueError("no valid triangles sampled; raise sample_num")
    w = np.asarray(areas, dtype=np.float64) ** area_type
    return (np.asarray(valid, dtype=np.int32),
            (w / w.sum()).astype(np.float32))


def unfold_patches(x, k_size: int, dilation: int = 1):
    """(B, H, W, C) -> (B, H, W, k·k, C): the zero-padded neighbourhoods,
    taps in torch's row-major window order."""
    d = dilation
    pad = d * (k_size - 1) // 2
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    return torch.stack([xp[:, dy * d:dy * d + H, dx * d:dx * d + W, :]
                        for dy in range(k_size) for dx in range(k_size)],
                       dim=3)


def _border_mask(h: int, w: int, k_size: int, dilation: int, dtype,
                 device=None):
    """(1, H, W, k·k): 1 where the tap falls inside the image."""
    ones = torch.ones((1, h, w, 1), dtype=dtype, device=device)
    return unfold_patches(ones, k_size, dilation)[..., 0]


def pa_gaussian_kernel(guide, k_size: int = 3, dilation: int = 1):
    """packernel2d (gaussian, channel_wise=False, normalize_kernel=True):
    per pixel p and tap q, exp(-0.5 · sum_c (g_q − g_p)²) with the
    unsmoothed centre, out-of-image taps zeroed, normalised over the taps
    (a sum of 0 divides by 1). guide (B, H, W, C) -> (B, H, W, k·k)."""
    B, H, W, C = guide.shape
    diff = unfold_patches(guide, k_size, dilation) - guide[:, :, :, None, :]
    aff = torch.exp(-0.5 * (diff * diff).sum(dim=-1))
    aff = aff * _border_mask(H, W, k_size, dilation, aff.dtype, aff.device)
    norm = aff.sum(dim=-1, keepdim=True)
    return aff / (norm + (norm == 0).to(norm.dtype))


def asn_guide_weight(guidance, k_size: int = 3, dilation: int = 1):
    """The smoothed kernel of DepthNormalConversion: the Gaussian kernel
    plus the uniform 1/k², renormalised and scaled by k² (taps average
    ~1)."""
    kk = k_size * k_size
    gw = pa_gaussian_kernel(guidance, k_size, dilation) + 1.0 / kk
    return gw / gw.sum(dim=-1, keepdim=True) * kk


def _pick(patches, index, n):
    """The taps of `index` (n·3,) along dim 3, as (..., n, 3[, C])."""
    tri = patches.index_select(3, index)
    return tri.reshape(*patches.shape[:3], n, 3, *patches.shape[4:])


def adaptive_depth_to_normals(depth, intrinsic, triplets, area_weights,
                              guide_weight=None, k_size: int = 3,
                              dilation: int = 1, depth_max: float = 10.0,
                              if_area: bool = True, if_pa: bool = True):
    """AdaptiveDepth2normal.forward: depth (B, H, W) metres, intrinsic
    (B, 3, 3), the (n, 3) triplets and (n,) area weights of
    `select_triangles`, guide_weight (B, H, W, k·k) or None (all ones).
    The camera-frame points of each pixel's window, the unit normal of
    each triangle, weights validity (all three taps in (0, depth_max)) x
    area x guidance at the three taps, a softmax over the triangles (it,
    not a mask, suppresses invalid ones: a window without a valid
    triangle averages all of them), the mixed normal unit-normalised and
    zeroed where the centre pixel is invalid. Returns (B, H, W, 3)."""
    B, H, W = depth.shape
    dt = torch.float64 if depth.dtype == torch.float64 else torch.float32
    dev = depth.device
    depth = depth.to(dt)
    K_inv = torch.linalg.inv(intrinsic.to(dt))
    u = torch.arange(W, dtype=dt, device=dev)[None, None, :].expand(1, H, W)
    v = torch.arange(H, dtype=dt, device=dev)[None, :, None].expand(1, H, W)
    pix = torch.stack([u, v, torch.ones((1, H, W), dtype=dt, device=dev)],
                      dim=-1)
    points = torch.einsum("bij,lhwj->bhwi", K_inv, pix) * depth[..., None]
    index = torch.as_tensor(np.asarray(triplets).reshape(-1),
                            dtype=torch.long, device=dev)
    n = index.numel() // 3
    tri = _pick(unfold_patches(points, k_size, dilation), index, n)
    normals = torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                                 tri[..., 2, :] - tri[..., 0, :], dim=-1)
    normals = normals / (torch.linalg.vector_norm(normals, dim=-1,
                                                  keepdim=True) + 1e-5)
    valid = ((depth > 0) & (depth < depth_max)).to(dt)
    vtri = _pick(unfold_patches(valid[..., None], k_size, dilation)[..., 0],
                 index, n)
    w = vtri[..., 0] * vtri[..., 1] * vtri[..., 2]
    if if_area:
        w = w * torch.as_tensor(np.asarray(area_weights), dtype=dt,
                                device=dev)
    if if_pa:
        if guide_weight is None:
            guide_weight = torch.ones((B, H, W, k_size * k_size), dtype=dt,
                                      device=dev)
        gtri = _pick(guide_weight.to(dt), index, n)
        w = w * gtri[..., 0] * gtri[..., 1] * gtri[..., 2]
    w = torch.softmax(w, dim=-1)
    mixed = (normals * w[..., None]).sum(dim=3)
    mixed = mixed / (torch.linalg.vector_norm(mixed, dim=-1, keepdim=True)
                     + 1e-5)
    return mixed * valid[..., None]


def depth_normal_conversion(depth, intrinsic, guidance, triplets,
                            area_weights, k_size: int = 3,
                            dilation: int = 1, depth_max: float = 10.0,
                            if_area: bool = True, if_pa: bool = True):
    """DepthNormalConversion.forward: the smoothed guidance kernel of
    guidance (B, H, W, C), or none, then `adaptive_depth_to_normals`."""
    gw = (None if guidance is None
          else asn_guide_weight(guidance, k_size, dilation))
    return adaptive_depth_to_normals(
        depth, intrinsic, triplets, area_weights, gw, k_size, dilation,
        depth_max, if_area=if_area, if_pa=if_pa)


class ASNSegHead(nn.Module):
    """SegHead: 3 x (3x3 conv without bias -> BatchNorm -> ReLU), one 1x1
    classifier per key, a sigmoid, and a bilinear resize (align_corners=
    True) to int(round(size · scale_factor)). forward(x NHWC) -> {key:
    (B, H', W', channels)}. in_channels defaults to mid_channels."""

    def __init__(self, mid_channels: int, output_channels: Sequence[int]
                 = (1,), class_key: Sequence[str] = ("disparity",),
                 scale_factor: float = 8.0,
                 in_channels: Optional[int] = None):
        super().__init__()
        self.class_key = tuple(class_key)
        self.scale_factor = scale_factor
        width = in_channels or mid_channels
        for i in range(3):
            self.add_module(f"fuse{i}", conv2d(width, mid_channels, 3,
                                               padding=1, bias=False))
            self.add_module(f"bn{i}", BatchNorm2d(mid_channels))
            width = mid_channels
        for key, ch in zip(self.class_key, output_channels):
            self.add_module(f"cls_{key}", conv2d(mid_channels, ch, 1))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fuse{i}")(x)))
        out = {}
        for key in self.class_key:
            m = torch.sigmoid(getattr(self, f"cls_{key}")(x)).permute(
                0, 2, 3, 1)
            size = (int(round(m.shape[1] * self.scale_factor)),
                    int(round(m.shape[2] * self.scale_factor)))
            out[key] = resize_bilinear(m, size, align_corners=True)
        return out


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """A sigmoid disparity in [0, 1] to metric depth by linear
    inverse-depth scaling (the JAX package's post-processor)."""
    min_disp, max_disp = 1.0 / max_depth, 1.0 / min_depth
    return 1.0 / (min_disp + (max_disp - min_disp) * disp)


class ASNDepthHeadV2(nn.Module):
    """The full ASN head: a disparity `ASNSegHead` and a guidance one over
    the same features, the disparity turned to depth, and with intrinsics
    the adaptive normals of that depth under the guidance's kernel.
    forward(features (B, H, W, C), intrinsic (B, 3, 3) or None) ->
    {"disp", "depth", "guidance": (B, H·s, W·s, 1), "normals": (B, H·s,
    W·s, 3) with intrinsics}. The triangle table is drawn once, at
    construction, from np.random.default_rng(triangle_seed).
    in_channels defaults to input_features_dim."""

    def __init__(self, input_features_dim: int = 128,
                 scale_factor: float = 8.0, k_size: int = 3,
                 sample_num: int = 40, min_depth: float = 0.1,
                 max_depth: float = 10.0, triangle_seed: int = 0,
                 in_channels: Optional[int] = None):
        super().__init__()
        self.k_size = k_size
        self.min_depth, self.max_depth = min_depth, max_depth
        self.depth_head = ASNSegHead(input_features_dim, (1,),
                                     ("disparity",), scale_factor,
                                     in_channels)
        self.guidance_head = ASNSegHead(input_features_dim, (1,),
                                        ("guidance",), scale_factor,
                                        in_channels)
        self.triplets, self.areas = select_triangles(
            k_size, sample_num, np.random.default_rng(triangle_seed))

    def forward(self, features, intrinsic=None):
        disp = self.depth_head(features)["disparity"]
        guidance = self.guidance_head(features)["guidance"]
        depth = disp_to_depth(disp, self.min_depth, self.max_depth)
        out = {"disp": disp, "depth": depth, "guidance": guidance}
        if intrinsic is not None:
            out["normals"] = depth_normal_conversion(
                depth[..., 0], intrinsic, guidance, self.triplets,
                self.areas, self.k_size, depth_max=self.max_depth)
        return out


def asn_losses(out, depth_gt, rgb=None, surface_normal_gt=None,
               sig_loss_weight: float = 1.0, smooth_weight: float = 0.001,
               normal_weight: float = 1.0, max_depth: float = 10.0):
    """The reference's loss dict: "supvised_loss" (its spelling), SigLoss
    of the depth where depth_gt > 0.1; with rgb (B, H, W, 3)
    "smooth_loss", the edge-aware smoothness of the disparity; with
    surface_normal_gt (B, H, W, 3) and normals in `out`
    "surface_norm_loss", 1 − cos under the same mask."""
    losses = {}
    mask = depth_gt > 0.1
    losses["supvised_loss"] = sig_loss_weight * sigloss(
        out["depth"][..., 0], depth_gt, valid=mask)
    if rgb is not None:
        losses["smooth_loss"] = edge_aware_smoothness_loss(
            out["disp"], rgb, loss_weight=smooth_weight)
    if surface_normal_gt is not None and "normals" in out:
        losses["surface_norm_loss"] = normal_weight * cosine_similarity_loss(
            out["normals"], surface_normal_gt, mask)
    return losses
