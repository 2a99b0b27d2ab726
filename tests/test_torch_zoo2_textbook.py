"""Textbook PyTorch oracles of the zoo's ViT, DPT head, AdaBins head and
timm EfficientNet under the reference's state-dict names, loaded into the
port through `convert.vit_official` and `convert.from_pth`.

The oracles are the textbook models of tests/test_parity_{vit,dpt,adabins,
efficientnet}.py, copied here with their constants (B0's stages and the
channel rounding) so that this file imports nothing of JAX or of the JAX
package: a timm-named ViT (fused qkv, exact GELU, eps 1e-6); mmseg's DPT
head, whose readout GELU is the tanh approximation here (the reference
builds the exact `nn.GELU()`; the JAX package takes flax's default tanh
approximation, and the port follows the JAX package); the AdaBins head
with torch's own `nn.TransformerEncoderLayer` in eval mode; and timm's
gen-efficientnet blocks with Conv2dSame.

Tolerance: rtol 1e-4 with atol 1e-5 of the largest value (f32 on both
sides, the same products in other orders).
"""
import math

import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

torch.set_num_threads(1)


def close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=err_msg)


# ---- ViT (timm naming) ----

class TAttention(tnn.Module):
    def __init__(self, c, heads):
        super().__init__()
        self.heads = heads
        self.qkv = tnn.Linear(c, 3 * c)
        self.proj = tnn.Linear(c, c)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads,
                                  C // self.heads).permute(2, 0, 3, 1, 4)
        att = (qkv[0] @ qkv[1].transpose(-2, -1)) * (C // self.heads) ** -0.5
        return self.proj((att.softmax(-1) @ qkv[2]).transpose(1, 2)
                         .reshape(B, N, C))


class TMlp(tnn.Module):
    def __init__(self, c):
        super().__init__()
        self.fc1 = tnn.Linear(c, 4 * c)
        self.fc2 = tnn.Linear(4 * c, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class TBlock(tnn.Module):
    def __init__(self, c, heads):
        super().__init__()
        self.norm1 = tnn.LayerNorm(c, eps=1e-6)
        self.attn = TAttention(c, heads)
        self.norm2 = tnn.LayerNorm(c, eps=1e-6)
        self.mlp = TMlp(c)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TViT(tnn.Module):
    def __init__(self, c=32, heads=4, depth=3, patch=16, grid=14):
        super().__init__()
        self.cls_token = tnn.Parameter(torch.randn(1, 1, c) * 0.02)
        self.pos_embed = tnn.Parameter(torch.randn(1, grid * grid + 1, c))
        self.patch_embed = tnn.Module()
        self.patch_embed.proj = tnn.Conv2d(3, c, patch, stride=patch)
        self.blocks = tnn.ModuleList(TBlock(c, heads) for _ in range(depth))
        self.norm = tnn.LayerNorm(c, eps=1e-6)       # the classifier's
        self.head = tnn.Linear(c, 10)

    def forward(self, img, out_indices):
        B = img.shape[0]
        x = self.patch_embed.proj(img).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], 1)
        x = x + self.pos_embed
        outs = []
        for i, b in enumerate(self.blocks):
            x = b(x)
            if i in out_indices:
                outs.append(x)
        return outs


def test_vit_official_checkpoint_gives_the_textbook_tokens():
    """A timm-named ViT (32 wide, 4 heads, 3 blocks, patch 16, the 14x14
    pretraining grid) through `convert_vit_official` at 224x224: every
    selected block's tokens, class token included; the classifier's keys
    are left out."""
    from gedepth_tpu_torch.convert.vit_official import convert_vit_official
    from gedepth_tpu_torch.models.vit import VisionTransformer

    torch.manual_seed(0)
    oracle = TViT().eval()
    sd = convert_vit_official(oracle.state_dict())
    assert not any(k.startswith(("norm.", "head.")) for k in sd)
    model = VisionTransformer(embed_dims=32, depth=3, num_heads=4,
                              out_indices=(0, 2)).eval()
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32))
    with torch.no_grad():
        want = oracle(x, (0, 2))
        got = model(x)
    assert len(got) == 2
    for (g, hw), w in zip(got, want):
        assert hw == (14, 14)
        close(g, w)


# ---- DPT head (mmseg dpt_head.py naming) ----

class TReassemble(tnn.Module):
    def __init__(self, e, post):
        super().__init__()
        self.projects = tnn.ModuleList()
        for c in post:
            m = tnn.Module()
            m.conv = tnn.Conv2d(e, c, 1)
            self.projects.append(m)
        self.resize_layers = tnn.ModuleList([
            tnn.ConvTranspose2d(post[0], post[0], 4, stride=4),
            tnn.ConvTranspose2d(post[1], post[1], 2, stride=2),
            tnn.Identity(),
            tnn.Conv2d(post[3], post[3], 3, stride=2, padding=1)])
        self.readout_projects = tnn.ModuleList([
            tnn.Sequential(tnn.Linear(2 * e, e), tnn.GELU(approximate="tanh"))
            for _ in post])

    def forward(self, inputs):
        out = []
        for i, (x, cls) in enumerate(inputs):
            shape = x.shape
            x = x.flatten(2).permute(0, 2, 1)
            readout = cls.unsqueeze(1).expand_as(x)
            x = self.readout_projects[i](torch.cat((x, readout), -1))
            x = x.permute(0, 2, 1).reshape(shape)
            out.append(self.resize_layers[i](self.projects[i].conv(x)))
        return out


class TRCU(tnn.Module):
    def __init__(self, c):
        super().__init__()
        for name in ("conv1", "conv2"):
            m = tnn.Module()
            m.conv = tnn.Conv2d(c, c, 3, padding=1, bias=False)
            setattr(self, name, m)

    def forward(self, x):
        return x + self.conv2.conv(F.relu(self.conv1.conv(F.relu(x))))


class TFusion(tnn.Module):
    def __init__(self, c, first=False):
        super().__init__()
        self.project = tnn.Module()
        self.project.conv = tnn.Conv2d(c, c, 1)
        if not first:
            self.res_conv_unit1 = TRCU(c)
        self.res_conv_unit2 = TRCU(c)

    def forward(self, x, skip=None):
        if skip is not None:
            if x.shape != skip.shape:
                x = F.interpolate(x, size=skip.shape[2:], mode="bilinear",
                                  align_corners=True)
            x = x + self.res_conv_unit1(skip)
        x = self.res_conv_unit2(x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        return self.project.conv(x)


class TDPTHead(tnn.Module):
    def __init__(self, e=32, post=(8, 16, 24, 32), ch=16, min_depth=1e-3):
        super().__init__()
        self.min_depth = min_depth
        self.reassemble_blocks = TReassemble(e, post)
        self.convs = tnn.ModuleList()
        for c in post:
            m = tnn.Module()
            m.conv = tnn.Conv2d(c, ch, 3, padding=1, bias=False)
            self.convs.append(m)
        self.fusion_blocks = tnn.ModuleList(
            [TFusion(ch, first=(i == 0)) for i in range(4)])
        self.project = tnn.Module()
        self.project.conv = tnn.Conv2d(ch, ch, 3, padding=1)
        self.conv_depth = tnn.Module()
        self.conv_depth.head = tnn.Sequential(
            tnn.Conv2d(ch, ch // 2, 3, padding=1),
            tnn.Upsample(scale_factor=2, mode="bilinear",
                         align_corners=True),
            tnn.Conv2d(ch // 2, 32, 3, padding=1), tnn.ReLU(),
            tnn.Conv2d(32, 1, 1))
        with torch.no_grad():           # biases that are not zero
            for m in self.modules():
                if isinstance(m, tnn.ConvTranspose2d):
                    m.bias.uniform_(-0.5, 0.5)

    def forward(self, inputs):
        x = self.reassemble_blocks(inputs)
        x = [self.convs[i].conv(f) for i, f in enumerate(x)]
        out = self.fusion_blocks[0](x[-1])
        for i in range(1, 4):
            out = self.fusion_blocks[i](out, x[-(i + 1)])
        out = F.relu(self.project.conv(out))
        return F.relu(self.conv_depth.head(out)) + self.min_depth


def _load_head(tmp_path, oracle, cfg_over, name):
    """A ZooDepther of the preset `name` with `oracle`'s state dict loaded
    as a reference `.pth` under `decode_head.` by `convert_checkpoint_file`;
    returns (model, report)."""
    import dataclasses

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.convert.from_pth import convert_checkpoint_file

    sd = {f"decode_head.{k}": v for k, v in oracle.state_dict().items()}
    path = str(tmp_path / f"{name}.pth")
    torch.save({"state_dict": sd}, path)
    model = dataclasses.replace(get_config(name).model, **cfg_over).build()
    return convert_checkpoint_file(path, model)


def test_dpt_reference_head_loads_and_matches(tmp_path):
    """The mmseg-named head through `convert_checkpoint_file` into a
    ZooDepther 'dpt' (embed 32, head 16): every head key maps, the
    transposed convs' per-channel biases spread over the sub-pixels, and
    the head gives the oracle's depth on the same four token maps."""
    torch.manual_seed(1)
    post = (8, 8, 16, 32)
    oracle = TDPTHead(32, post, 16).eval()
    model, report = _load_head(tmp_path, oracle, dict(
        head_channels=16, backbone_embed_dims=32, backbone_depth=4),
        "dpt_kitti")
    assert report["unmapped_torch_keys"] == []
    assert not [k for k in report["missing_params"]
                if k.startswith("decode_head.")]
    rng = np.random.default_rng(2)
    maps = [rng.standard_normal((2, 32, 4, 8)).astype(np.float32)
            for _ in range(4)]
    cls = [rng.standard_normal((2, 32)).astype(np.float32) for _ in range(4)]
    tokens = [(torch.from_numpy(np.concatenate(
        [c[:, None], m.reshape(2, 32, 32).transpose(0, 2, 1)], axis=1)),
        (4, 8)) for m, c in zip(maps, cls)]
    with torch.no_grad():
        want = oracle([(torch.from_numpy(m), torch.from_numpy(c))
                       for m, c in zip(maps, cls)])
        got = model.decode_head(tokens)
    close(got, want)


# ---- AdaBins head (adabins_head.py naming) ----

class TConvModule(tnn.Module):
    def __init__(self, cin, cout, k, act):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, k, padding=k // 2)
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        return self.act(x) if self.act is not None else x


class TUpSample(tnn.Module):
    def __init__(self, skip_input, cout):
        super().__init__()
        self.convA = TConvModule(skip_input, cout, 3, F.relu)
        self.convB = TConvModule(cout, cout, 3, F.relu)

    def forward(self, x, concat_with):
        up = F.interpolate(x, size=concat_with.shape[2:], mode="bilinear",
                           align_corners=True)
        return self.convB(self.convA(torch.cat([up, concat_with], 1)))


class TPatchTransformer(tnn.Module):
    def __init__(self, cin, e, ps):
        super().__init__()
        layer = tnn.TransformerEncoderLayer(e, 4, dim_feedforward=1024)
        self.transformer_encoder = tnn.TransformerEncoder(
            layer, 4, enable_nested_tensor=False)
        self.embedding_convPxP = tnn.Conv2d(cin, e, ps, stride=ps)
        self.positional_encodings = tnn.Parameter(torch.rand(500, e))

    def forward(self, x):
        emb = self.embedding_convPxP(x).flatten(2)
        emb = emb + self.positional_encodings[:emb.shape[2], :].T.unsqueeze(0)
        return self.transformer_encoder(emb.permute(2, 0, 1))


class TmViT(tnn.Module):
    def __init__(self, e, nb, ps):
        super().__init__()
        self.e = e
        self.patch_transformer = TPatchTransformer(e, e, ps)
        self.conv3x3 = tnn.Conv2d(e, e, 3, padding=1)
        self.regressor = tnn.Sequential(
            tnn.Linear(e, 256), tnn.LeakyReLU(),
            tnn.Linear(256, 256), tnn.LeakyReLU(), tnn.Linear(256, nb))

    def forward(self, x):
        tgt = self.patch_transformer(x.clone())
        x = self.conv3x3(x)
        head, queries = tgt[0], tgt[1:self.e + 1].permute(1, 0, 2)
        n, c, h, w = x.shape
        attn = torch.matmul(x.view(n, c, h * w).permute(0, 2, 1),
                            queries.permute(0, 2, 1))
        attn = attn.permute(0, 2, 1).view(n, self.e, h, w)
        y = torch.relu(self.regressor(head)) + 0.1
        return y / y.sum(dim=1, keepdim=True), attn


class TAdabinsHead(tnn.Module):
    """in_ch and up_ch coarse to fine."""

    def __init__(self, in_ch, up_ch, e=16, nb=32, ps=16, min_depth=1e-3,
                 max_depth=10.0):
        super().__init__()
        self.nb, self.min_depth, self.max_depth = nb, min_depth, max_depth
        self.conv_list = tnn.ModuleList()
        prev = 0
        for i, (cin, cup) in enumerate(zip(in_ch, up_ch)):
            self.conv_list.append(TConvModule(cin, cup, 1, None) if i == 0
                                  else TUpSample(cin + prev, cup))
            prev = cup
        self.decode_final_conv = tnn.Conv2d(up_ch[-1], e, 3, padding=1)
        self.adaptive_bins_layer = TmViT(e, nb, ps)
        self.conv_out = tnn.Sequential(tnn.Conv2d(e, nb, 1),
                                       tnn.Softmax(dim=1))

    def forward(self, inputs):
        feats = []
        for i, feat in enumerate(inputs[::-1]):
            feats.append(self.conv_list[i](feat) if i == 0
                         else self.conv_list[i](feats[i - 1], feat))
        widths, attn = self.adaptive_bins_layer(
            self.decode_final_conv(feats[-1]))
        probs = self.conv_out(attn)
        widths = F.pad((self.max_depth - self.min_depth) * widths, (1, 0),
                       value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        depth = torch.sum(probs * centers.view(-1, self.nb, 1, 1), dim=1,
                          keepdim=True)
        return depth, edges


def test_adabins_reference_head_loads_and_matches(tmp_path):
    """The reference-named head (torch's packed `in_proj_weight`) through
    `convert_checkpoint_file` into a ZooDepther 'adabins' (b0, head 16, 32
    bins): every head key maps, and the head gives the oracle's depth and
    bin edges on the same b0-shaped pyramid (/4 at 96x160: 24 patches of
    16 for 16 range queries)."""
    torch.manual_seed(3)
    in_ch = (24, 40, 112, 320)                  # b0, fine to coarse
    up_ch = (16, 32, 64, 128)
    oracle = TAdabinsHead(in_ch[::-1], up_ch[::-1], 16, 32).eval()
    model, report = _load_head(tmp_path, oracle,
                               dict(head_channels=16, n_bins=32),
                               "adabins_nyu")
    assert report["unmapped_torch_keys"] == []
    assert not [k for k in report["missing_params"]
                if k.startswith("decode_head.")]
    rng = np.random.default_rng(4)
    feats = [torch.from_numpy(rng.standard_normal(
        (2, c, 96 // s, 160 // s)).astype(np.float32))
        for s, c in zip((1, 2, 4, 8), in_ch)]
    with torch.no_grad():
        want_d, want_e = oracle(feats)
        got_d, got_e = model.decode_head(feats)
    close(got_e, want_e, "edges")
    close(got_d, want_d, "depth")


# ---- timm's EfficientNet (gen-efficientnet naming) ----

B0_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
             (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
             (6, 320, 1, 1, 3))
TEST_SCALE = (0.5, 0.5)      # width, depth: B5's structure at small widths


def round_ch(c, mult, divisor=8):
    c = c * mult
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:
        new += divisor
    return int(new)


class TConvSame(tnn.Conv2d):
    def __init__(self, cin, cout, k, stride=1, groups=1, bias=False):
        super().__init__(cin, cout, k, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x):
        ih, iw = x.shape[-2:]
        k, s = self.kernel_size[0], self.stride[0]
        ph = max(0, (math.ceil(ih / s) - 1) * s + k - ih)
        pw = max(0, (math.ceil(iw / s) - 1) * s + k - iw)
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self._conv_forward(x, self.weight, self.bias)


class TSE(tnn.Module):
    def __init__(self, mid, reduced):
        super().__init__()
        self.conv_reduce = tnn.Conv2d(mid, reduced, 1, bias=True)
        self.conv_expand = tnn.Conv2d(reduced, mid, 1, bias=True)

    def forward(self, x):
        s = self.conv_expand(F.silu(self.conv_reduce(
            x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class TDS(tnn.Module):
    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.conv_dw = TConvSame(cin, cin, k, stride, groups=cin)
        self.bn1 = tnn.BatchNorm2d(cin, eps=1e-3)
        self.se = TSE(cin, max(1, int(cin * 0.25)))
        self.conv_pw = TConvSame(cin, cout, 1)
        self.bn2 = tnn.BatchNorm2d(cout, eps=1e-3)
        self.res = stride == 1 and cin == cout

    def forward(self, x):
        h = self.se(F.silu(self.bn1(self.conv_dw(x))))
        h = self.bn2(self.conv_pw(h))
        return h + x if self.res else h


class TIR(tnn.Module):
    def __init__(self, cin, cout, expand, k, stride):
        super().__init__()
        mid = cin * expand
        self.conv_pw = TConvSame(cin, mid, 1)
        self.bn1 = tnn.BatchNorm2d(mid, eps=1e-3)
        self.conv_dw = TConvSame(mid, mid, k, stride, groups=mid)
        self.bn2 = tnn.BatchNorm2d(mid, eps=1e-3)
        self.se = TSE(mid, max(1, int(cin * 0.25)))
        self.conv_pwl = TConvSame(mid, cout, 1)
        self.bn3 = tnn.BatchNorm2d(cout, eps=1e-3)
        self.res = stride == 1 and cin == cout

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = self.se(F.silu(self.bn2(self.conv_dw(h))))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.res else h


class TTimmEffNet(tnn.Module):
    def __init__(self, wm, dm):
        super().__init__()
        stem = round_ch(32, wm)
        self.conv_stem = TConvSame(3, stem, 3, 2)
        self.bn1 = tnn.BatchNorm2d(stem, eps=1e-3)
        blocks, cin = [], stem
        for si, (expand, ch, reps, s0, k) in enumerate(B0_STAGES):
            ch = round_ch(ch, wm)
            stage = []
            for r in range(int(math.ceil(reps * dm))):
                s = s0 if r == 0 else 1
                stage.append(TDS(cin, ch, k, s) if si == 0
                             else TIR(cin, ch, expand, k, s))
                cin = ch
            blocks.append(tnn.ModuleList(stage))
        self.blocks = tnn.ModuleList(blocks)
        self.conv_head = TConvSame(cin, round_ch(1280, wm), 1)
        self.bn2 = tnn.BatchNorm2d(round_ch(1280, wm), eps=1e-3)
        self.classifier = tnn.Linear(round_ch(1280, wm), 10)

    def forward(self, x):
        x = F.silu(self.bn1(self.conv_stem(x)))
        outs = []
        for si, stage in enumerate(self.blocks):
            for b in stage:
                x = b(x)
            if si in (0, 1, 2, 4):
                outs.append(x)
        outs.append(self.conv_head(x))
        return outs


@pytest.fixture
def timm_test_scale(monkeypatch):
    from gedepth_tpu_torch.models import efficientnet

    monkeypatch.setitem(efficientnet.TIMM_SCALES, "tf_test", TEST_SCALE)


def test_timm_efficientnet_reference_backbone_loads_and_matches(
        tmp_path, timm_test_scale):
    """timm's blocks under `backbone.original_model.` through
    `convert_checkpoint_file` into a ZooDepther 'adabins' with a tf_
    backbone at half width and depth: every backbone key maps (the head's
    `bn2` and `classifier` dropped), and the five endpoints equal the
    oracle's at 66x98, where TF 'SAME' padding is asymmetric."""
    import dataclasses

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.convert.from_pth import convert_checkpoint_file

    torch.manual_seed(5)
    oracle = TTimmEffNet(*TEST_SCALE).eval()
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.7, 1.4)
    sd = {f"backbone.original_model.{k}": v
          for k, v in oracle.state_dict().items()}
    path = str(tmp_path / "timm.pth")
    torch.save(sd, path)
    model = dataclasses.replace(
        get_config("adabins_nyu").model, backbone_variant="tf_test",
        head_channels=4, n_bins=8).build()
    _, report = convert_checkpoint_file(path, model)
    assert report["unmapped_torch_keys"] == []
    assert report["unused_torch_keys"] == []
    assert not [k for k in report["missing_params"] + report["missing_stats"]
                if k.startswith("backbone.")]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 3, 66, 98)).astype(np.float32))
    with torch.no_grad():
        want = oracle(x)
        got = model.backbone(x)
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, str(i))
