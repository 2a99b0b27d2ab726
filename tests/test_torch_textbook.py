"""A textbook PyTorch GEDepth as an oracle for the port, without JAX.

`TorchGEDepth` is the full model written plainly (DepthFormer-Swin, HAHI
with `F.grid_sample` deformable attention, the PE necks, DenseDepth and the
fusion) with the reference's key names. Its `state_dict` is what a
reference `.pth` holds, so it feeds the converters of both packages. It is
a copy of the textbook model of tests/test_composite_parity.py, with the
helpers that file takes from the JAX package (`relative_position_index`,
`shifted_window_mask`, `_center_reference_points`,
`sine_positional_encoding`) copied from there as numpy, so that the oracle
depends on neither package under test and imports on a machine without
JAX (the card's tests use it: tests/test_torch_kernels_cuda.py).

The widths are module constants, at the tiny scale of the original by
default; `SCALE` is the Swin-S-ish scale of
tests/test_composite_deltas.py (set with `monkeypatch.setattr`, as there).

Tests, on the CPU: the textbook weights converted by the port's
`convert/from_pth.py` give the port's exact f32 depth equal to the JAX
package's exact forward on the same weights converted by
`gedepth_tpu.convert.torch_to_jax`, rtol 1e-4, atol 1e-4 m, and to the
textbook's own forward (rtol 1e-4, atol 1e-4 m; the textbook samples with
`grid_sample` and merges patches with `F.unfold`, the same sums in another
order): at the tiny scale in Tier-1, at SCALE under `slow`.
"""
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

# ---- test scale (tests/test_composite_parity.py) ---------------------------
H_IMG, W_IMG = 64, 128
EMBED = 16
DEPTHS = (1, 1, 2, 1)
HEADS = (2, 2, 4, 8)
WINDOW = 2
NECK_CH = (64, 16, 32, 64, 128)
NECK_EMBED = 32
NECK_HEADS = 8
NECK_POINTS = 4
MIN_D, MAX_D = 1e-3, 80.0
DEPTH_SCALE = 200.0
CAM_H = 1.65

# the Swin-S-ish scale of tests/test_composite_deltas.py: window 4 (N = 16,
# head dim 32 in every stage), neck d = 256 / 8 = 32
SCALE = dict(
    H_IMG=128, W_IMG=256, EMBED=64, DEPTHS=(2, 2, 6, 2),
    HEADS=(2, 4, 8, 16), WINDOW=4, NECK_CH=(64, 64, 128, 256, 512),
    NECK_EMBED=256, NECK_HEADS=8, NECK_POINTS=8)


# ---- numpy copies of the JAX package's helpers -----------------------------

def relative_position_index(wh, ww):
    """gedepth_tpu/models/swin.py `relative_position_index`."""
    ys, xs = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    rel_y = ys[:, None] - ys[None, :] + wh - 1
    rel_x = xs[:, None] - xs[None, :] + ww - 1
    return (rel_y * (2 * ww - 1) + rel_x).astype(np.int32)


def shifted_window_mask(h_pad, w_pad, window, shift):
    """gedepth_tpu/models/swin.py `shifted_window_mask`."""
    img_mask = np.zeros((h_pad, w_pad), dtype=np.int32)
    h_slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    w_slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in h_slices:
        for ws in w_slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    nh, nw = h_pad // window, w_pad // window
    win = img_mask.reshape(nh, window, nw, window).transpose(0, 2, 1, 3)
    win = win.reshape(nh * nw, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _center_reference_points(spatial_shapes):
    """gedepth_tpu/models/hahi.py `_center_reference_points`."""
    pts = []
    for (H_, W_) in spatial_shapes:
        ys = (np.arange(H_, dtype=np.float32) + 0.5) / H_
        xs = (np.arange(W_, dtype=np.float32) + 0.5) / W_
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
    ref = np.concatenate(pts, axis=0)
    L = len(spatial_shapes)
    return np.tile(ref[:, None, :], (1, L, 1))


def sine_positional_encoding(h, w, num_feats=256, temperature=10000.0):
    """gedepth_tpu/models/layers.py `sine_positional_encoding`, in f32
    numpy."""
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None]
    x_embed = np.arange(1, w + 1, dtype=np.float32)[None, :]
    dim_t = np.arange(num_feats, dtype=np.float32)
    dim_t = (temperature ** (2 * (dim_t // 2) / num_feats)).astype(np.float32)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                     axis=3).reshape(1, w, num_feats)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                     axis=3).reshape(h, 1, num_feats)
    pos_x = np.broadcast_to(pos_x, (h, w, num_feats))
    pos_y = np.broadcast_to(pos_y, (h, w, num_feats))
    return np.concatenate([pos_y, pos_x], axis=2).astype(np.float32)


# ---- torch building blocks (reference key names) --------------------------

class TConvModule(nn.Module):
    """mmcv ConvModule: conv(no bias) + BN + ReLU."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class TWMSA(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.dim, self.heads, self.window = dim, heads, window
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.randn((2 * window - 1) ** 2, heads) * 0.02)
        idx = relative_position_index(window, window)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(np.asarray(idx)).long())

    def forward(self, x, mask=None):
        B, N, C = x.shape
        scale = (C // self.heads) ** -0.5
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * scale) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(N, N, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(B // nW, nW, self.heads, N, N) + \
                mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, N, N)
        attn = attn.softmax(dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, N, C))


class TAttnWrap(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.w_msa = TWMSA(dim, heads, window)

    def forward(self, x, mask=None):
        return self.w_msa(x, mask)


class TFFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Sequential(nn.Linear(dim, hidden), nn.GELU()),
            nn.Linear(hidden, dim)])

    def forward(self, x):
        return self.layers[1](self.layers[0](x))


class TSwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shift):
        super().__init__()
        self.window, self.shift = window, (window // 2 if shift else 0)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = TAttnWrap(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = TFFN(dim, 4 * dim)

    def forward(self, x, hw):
        B, L, C = x.shape
        H, W = hw
        w = self.window
        identity = x
        x = self.norm1(x).view(B, H, W, C)
        if self.shift:
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
            mask = torch.from_numpy(np.asarray(
                shifted_window_mask(H, W, w, self.shift))).to(x.device)
        else:
            mask = None
        x = x.view(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(-1, w * w, C)
        x = self.attn(x, mask)
        x = x.view(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, H, W, C)
        if self.shift:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        x = identity + x.reshape(B, L, C)
        return x + self.ffn(self.norm2(x))


class TPatchMerging(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm = nn.LayerNorm(4 * cin, eps=1e-5)
        self.reduction = nn.Linear(4 * cin, cout, bias=False)

    def forward(self, x, hw):
        B, L, C = x.shape
        H, W = hw
        x = x.view(B, H, W, C).permute(0, 3, 1, 2)
        x = F.unfold(x, kernel_size=2, stride=2).transpose(1, 2)
        return self.reduction(self.norm(x)), (H // 2, W // 2)


class TStage(nn.Module):
    def __init__(self, dim, depth, heads, window, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(
            [TSwinBlock(dim, heads, window, shift=(d % 2 == 1))
             for d in range(depth)])
        self.downsample = (TPatchMerging(dim, 2 * dim) if downsample
                           else None)


class TPatchEmbed(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.projection = nn.Conv2d(cin, dim, 4, 4)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.projection(x)
        B, C, H, W = x.shape
        x = x.flatten(2).transpose(1, 2)
        return self.norm(x), (H, W)


class TBackbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.patch_embed = TPatchEmbed(4, EMBED)
        dims = [EMBED * (2 ** i) for i in range(4)]
        self.stages = nn.ModuleList([
            TStage(dims[i], DEPTHS[i], HEADS[i], WINDOW, i < 3)
            for i in range(4)])
        for i in range(4):
            setattr(self, f"norm{i}", nn.LayerNorm(dims[i], eps=1e-5))

    def forward(self, img5):
        stem = F.relu(self.bn1(self.conv1(img5[:, :3])))
        x, hw = self.patch_embed(img5[:, :4])
        outs = [stem]
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x, hw)
            out = getattr(self, f"norm{i}")(x)
            B = out.shape[0]
            outs.append(out.view(B, hw[0], hw[1], -1).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x, hw = stage.downsample(x, hw)
        return outs


def torch_msda_core(levels, locs, weights):
    """levels: list of (B, h, d, H, W); locs (B, Nq, h, L, P, 2) normalized;
    weights (B, Nq, h, L, P). grid_sample bilinear/zeros/align=False."""
    B, Nq, h, L, P, _ = locs.shape
    out = 0.0
    for l, v in enumerate(levels):
        d = v.shape[2]
        v2 = v.reshape(B * h, d, v.shape[3], v.shape[4])
        grid = locs[:, :, :, l] * 2 - 1                   # (B,Nq,h,P,2)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(B * h, Nq, P, 2)
        s = F.grid_sample(v2, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)            # (B*h, d, Nq, P)
        w = weights[:, :, :, l].permute(0, 2, 1, 3).reshape(B * h, 1, Nq, P)
        out = out + (s * w).sum(-1)                       # (B*h, d, Nq)
    out = out.reshape(B, h, -1, Nq).permute(0, 3, 1, 2)
    return out.reshape(B, Nq, -1)


class TMSDA(nn.Module):
    def __init__(self, embed, heads, L, P):
        super().__init__()
        self.heads, self.L, self.P = heads, L, P
        self.value_proj = nn.Linear(embed, embed)
        self.sampling_offsets = nn.Linear(embed, heads * L * P * 2)
        self.attention_weights = nn.Linear(embed, heads * L * P)
        self.output_proj = nn.Linear(embed, embed)

    def forward(self, query, value, qpos, ref, shapes):
        B, Nq, C = query.shape
        h, L, P = self.heads, self.L, self.P
        identity = query
        q = query + qpos
        v = self.value_proj(value)
        off = self.sampling_offsets(q).reshape(B, Nq, h, L, P, 2)
        w = self.attention_weights(q).reshape(B, Nq, h, L * P)
        w = w.softmax(-1).reshape(B, Nq, h, L, P)
        normalizer = torch.tensor([[W_, H_] for (H_, W_) in shapes],
                                  dtype=torch.float32, device=query.device)
        locs = ref[:, :, None, :, None, :] + \
            off / normalizer[None, None, None, :, None, :]
        levels, start = [], 0
        for (H_, W_) in shapes:
            n = H_ * W_
            lv = v[:, start:start + n].reshape(B, H_, W_, h, C // h)
            levels.append(lv.permute(0, 3, 4, 1, 2))
            start += n
        out = torch_msda_core(levels, locs, w)
        return identity + self.output_proj(out)


class TNeck(nn.Module):
    def __init__(self):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [TConvModule(c, c, 1) for c in NECK_CH])
        self.trans_proj = nn.ModuleList(
            [TConvModule(c, NECK_EMBED, 1) for c in NECK_CH[1:]])
        self.level_embed = nn.Parameter(torch.randn(4, NECK_EMBED))
        self.self_attn = TMSDA(NECK_EMBED, NECK_HEADS, 4, NECK_POINTS)
        self.reference_points = nn.Linear(NECK_EMBED, 2)
        self.multi_att = TMSDA(NECK_EMBED, NECK_HEADS, 4, NECK_POINTS)
        self.conv_proj = nn.Sequential(TConvModule(NECK_CH[0], NECK_EMBED, 1))
        self.conv_fusion = nn.Sequential(
            TConvModule(NECK_EMBED + NECK_CH[0], NECK_CH[0], 3))
        self.trans_fusion = nn.ModuleList(
            [TConvModule(c + NECK_EMBED, c, 3) for c in NECK_CH[1:]])

    def forward(self, feats):
        feats = [m(f) for m, f in zip(self.lateral_convs, feats)]
        conv_feat, trans = feats[0], feats[1:]
        shapes = tuple((f.shape[2], f.shape[3]) for f in trans)
        num_feats = NECK_EMBED // 2
        dev = conv_feat.device
        src, pos = [], []
        for i, f in enumerate(trans):
            p = self.trans_proj[i](f)
            B, C, H_, W_ = p.shape
            src.append(p.flatten(2).transpose(1, 2))
            sine = sine_positional_encoding(H_, W_, num_feats)
            sine = torch.from_numpy(sine.reshape(1, H_ * W_, -1)).to(dev)
            pos.append(sine + self.level_embed[i][None, None])
        src = torch.cat(src, 1)
        pos = torch.cat(pos, 1)

        ref_self = torch.from_numpy(
            _center_reference_points(shapes).astype(np.float32))[None].to(dev)
        src = self.self_attn(src, src, pos, ref_self, shapes)

        B, _, Hc, Wc = conv_feat.shape
        query = self.conv_proj(conv_feat).flatten(2).transpose(1, 2)
        qpos = sine_positional_encoding(Hc, Wc, num_feats)
        qpos = torch.from_numpy(qpos.reshape(1, Hc * Wc, -1)).to(dev)
        ref_q = torch.sigmoid(self.reference_points(qpos))
        ref_q = ref_q[:, :, None, :].expand(B, -1, 4, -1)
        fused = self.multi_att(query, src, qpos, ref_q, shapes)
        fused = fused.transpose(1, 2).reshape(B, NECK_EMBED, Hc, Wc)
        out = [self.conv_fusion(torch.cat([fused, conv_feat], 1))]
        start = 0
        for i, f in enumerate(trans):
            H_, W_ = shapes[i]
            n = H_ * W_
            tok = src[:, start:start + n].transpose(1, 2).reshape(
                B, NECK_EMBED, H_, W_)
            start += n
            out.append(self.trans_fusion[i](torch.cat([f, tok], 1)))
        return out


class TScaleNeck(nn.Module):
    """pe_mask_neck / dynamic_pe_neck: 5-scale 3x3 fuse + final conv."""

    def __init__(self, out_ch):
        super().__init__()
        for i, c in enumerate(NECK_CH[::-1]):
            setattr(self, f"conv{i}", nn.Conv2d(c, 64, 3, 1, 1))
        self.convfinal = nn.Conv2d(64, out_ch, 3, 1, 1)

    def forward(self, feats):
        target = feats[0].shape[2:]
        fused = 0.0
        for i, x in enumerate(feats[::-1]):
            y = getattr(self, f"conv{i}")(x)
            if y.shape[2:] != target:
                y = F.interpolate(y, target, mode="bilinear",
                                  align_corners=True)
            fused = fused + y
        return self.convfinal(fused), fused


class _PlainConv(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, 1, k // 2)


class TUpBlock(nn.Module):
    def __init__(self, cin, skip, cout):
        super().__init__()
        self.convA = _PlainConv(cin + skip, cout)
        self.convB = _PlainConv(cout, cout)

    def forward(self, x, s):
        x = F.interpolate(x, s.shape[2:], mode="bilinear",
                          align_corners=True)
        x = F.leaky_relu(self.convA.conv(torch.cat([x, s], 1)), 0.01)
        return F.leaky_relu(self.convB.conv(x), 0.01)


class THead(nn.Module):
    def __init__(self):
        super().__init__()
        up = list(NECK_CH)[::-1]
        mods = [_PlainConv(up[0], up[0], k=1)]
        for i in range(1, 5):
            skip = list(NECK_CH)[::-1][i]
            mods.append(TUpBlock(up[i - 1], skip, up[i]))
        self.conv_list = nn.ModuleList(mods)
        self.conv_depth = nn.Conv2d(up[-1], 1, 3, 1, 1)

    def forward(self, feats, pe_mask, y):
        fr = feats[::-1]
        x = self.conv_list[0].conv(fr[0])
        for i in range(1, 5):
            x = self.conv_list[i](x, fr[i])
        d = F.relu(self.conv_depth(x))
        if pe_mask is not None:
            pe = F.interpolate(pe_mask, d.shape[2:], mode="bilinear",
                               align_corners=True)
            y_r = F.interpolate(y, d.shape[2:], mode="bilinear",
                                align_corners=True)
            return d * (1 - y_r) + pe + MIN_D
        return d + MIN_D


class TorchGEDepth(nn.Module):
    def __init__(self, variant):
        super().__init__()
        self.variant = variant
        self.backbone = TBackbone()
        self.neck = TNeck()
        self.pe_mask_neck = TScaleNeck(1)
        if variant == "adaptive":
            self.dynamic_pe_neck = TScaleNeck(11)
        self.decode_head = THead()

    def forward(self, img5):
        B, _, H, W = img5.shape
        feats = self.backbone(img5)
        feats = self.neck(feats)
        y_small, _ = self.pe_mask_neck(feats)
        y = torch.sigmoid(y_small)
        y = F.interpolate(y, (H, W), mode="bilinear", align_corners=False)
        if self.variant == "adaptive":
            logits, _ = self.dynamic_pe_neck(feats)
            logits = F.interpolate(logits, (H, W), mode="bilinear",
                                   align_corners=False)
            probs = logits.softmax(1)
            bins = torch.linspace(-5.0, 5.0, 11, device=img5.device)
            slope = (probs * bins[None, :, None, None]).sum(1, keepdim=True)
            t = torch.tan(torch.deg2rad(slope))
            pe_comput = img5[:, 4:5]
            a = -CAM_H / (pe_comput + 1e-8)
            off = -CAM_H / ((a - t) + 1e-8)
            valid = ((off > 0) & (off <= DEPTH_SCALE)).float()
            pe_mask = off * valid * y
        else:
            pe_mask = img5[:, 3:4] * y * 200.0
        d = self.decode_head(feats, pe_mask, y)
        d = d.clamp(MIN_D, MAX_D)
        return F.interpolate(d, (H, W), mode="bilinear", align_corners=True)


def _rand_batch(rng, flip=False):
    img = rng.standard_normal((2, H_IMG, W_IMG, 5)).astype(np.float32)
    img[..., 3] = np.abs(img[..., 3]) * 0.3
    img[..., 4] = np.abs(img[..., 4]) * 30 + 1.0
    return img


# ---- the oracle's weights in the port --------------------------------------

def textbook(variant="adaptive"):
    """The textbook model from torch seed 0, in eval mode, with its
    BatchNorm statistics drawn as the JAX tests draw them (so that their
    conversion matters)."""
    torch.manual_seed(0)
    tm = TorchGEDepth(variant).eval()
    for m in tm.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    return tm


def port_model(variant="adaptive", **over):
    """The port's `GEDepth` at the oracle's widths (exact sampling unless
    `over` says otherwise), in eval mode on the CPU."""
    from gedepth_tpu_torch.models.depther import GEDepth

    kw = dict(embed_dims=EMBED, depths=DEPTHS, num_heads=HEADS,
              window=WINDOW, drop_path_rate=0.0, neck_channels=NECK_CH,
              neck_embed_dim=NECK_EMBED, neck_num_points=NECK_POINTS,
              head_channels=16, min_depth=MIN_D, max_depth=MAX_D,
              pe_variant=variant, depth_scale=DEPTH_SCALE,
              default_cam_height=CAM_H)
    kw.update(over)
    return GEDepth(**kw).eval()


def load_converted(tm, model, path):
    """Write the textbook's `state_dict` to `path` as a reference `.pth`
    (unless it is there) and load it into `model` through
    `convert/from_pth.py`; every key of the model comes from the file."""
    import os

    from gedepth_tpu_torch.convert.from_pth import convert_checkpoint_file

    if not os.path.exists(path):
        torch.save({"state_dict": tm.state_dict()}, path)
    _, report = convert_checkpoint_file(str(path), model)
    assert not any(report.values()), report
    return model


def abs_rel(ref, x):
    return float(np.mean(np.abs(x - ref) / np.maximum(ref, MIN_D)))


# ---- CPU tests against the JAX package -------------------------------------

def _jax_exact(tm, img):
    """The JAX package's exact depth (B, H, W, 1) on the textbook weights,
    converted by `gedepth_tpu.convert.torch_to_jax`."""
    import jax
    import jax.numpy as jnp
    from gedepth_tpu.convert.torch_to_jax import (
        _merge_into, convert_state_dict)
    from gedepth_tpu.models.depther import GEDepth

    jm = GEDepth(embed_dims=EMBED, depths=DEPTHS, num_heads=HEADS,
                 window=WINDOW, drop_path_rate=0.0, neck_channels=NECK_CH,
                 neck_embed_dim=NECK_EMBED, neck_num_points=NECK_POINTS,
                 head_channels=16, min_depth=MIN_D, max_depth=MAX_D,
                 pe_variant="adaptive", depth_scale=DEPTH_SCALE,
                 default_cam_height=CAM_H)
    ch = jnp.full((img.shape[0],), CAM_H, jnp.float32)
    params, stats, unmapped = convert_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    assert not unmapped
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                               jnp.asarray(img), ch)
    merged_p, miss_p = _merge_into(variables["params"], params)
    merged_s, miss_s = _merge_into(variables["batch_stats"], stats)
    assert not miss_p and not miss_s
    out = jax.jit(lambda v, x: jm.apply(v, x, ch, method=jm.predict_depth))(
        {"params": merged_p, "batch_stats": merged_s}, jnp.asarray(img))
    return np.asarray(out)


def _hold_port_to_oracle_and_jax(tmp_path, img):
    torch.set_num_threads(1)
    tm = textbook()
    model = load_converted(tm, port_model(), tmp_path / "textbook.pth")
    x = torch.from_numpy(img)
    with torch.no_grad():
        got = model.predict_depth(x, torch.full((img.shape[0],), CAM_H))
        oracle = tm(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
    got = got.numpy()
    want = _jax_exact(tm, img)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, oracle.numpy(), rtol=1e-4, atol=1e-4)
    print(f"port against JAX: abs-rel {abs_rel(want, got):.3e}, against the "
          f"textbook {abs_rel(oracle.numpy(), got):.3e}")


def test_textbook_weights_through_from_pth_match_jax(tmp_path):
    _hold_port_to_oracle_and_jax(tmp_path, _rand_batch(
        np.random.default_rng(0)))


@pytest.mark.slow
def test_textbook_weights_through_from_pth_match_jax_at_scale(
        tmp_path, monkeypatch):
    import sys

    for k, v in SCALE.items():
        monkeypatch.setattr(sys.modules[__name__], k, v)
    _hold_port_to_oracle_and_jax(tmp_path, _rand_batch(
        np.random.default_rng(7))[:1])
