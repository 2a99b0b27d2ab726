"""A textbook PyTorch BinsFormer as an oracle for the port, without JAX.

`TBinsFormerDepther` is a Swin-T-shaped DepthFormer backbone without ground
embedding (3-channel patch embed) and the reference BinsFormer decode head
(binsformer_head.py with PureMSDEnTransformer and PixelTransformerDecoder
of transformer.py) written plainly under the reference's key names: mmcv's
ConvModules, `F.grid_sample` deformable attention, torch's
`nn.MultiheadAttention` in the decoder. The head is the textbook of
tests/test_parity_binsformer.py, its widths made parameters; the Swin
blocks, `TMSDA` and the numpy helpers (`sine_positional_encoding`,
`_center_reference_points`) come from tests/test_torch_textbook.py, which
imports no JAX, so that this oracle runs on a machine without it.

Its `state_dict` is a reference `.pth`; loaded through the port's
`convert/from_pth.py` into `ZooDepther` 'binsformer' (with and without the
released checkpoints' key layout, `binsformer_release`), every key maps,
and the port gives the oracle's outputs: every decoder layer's depth, bin
edges and class logits on the same pyramid, and the whole model's final
depth from the same frames. Widths: Swin embed 16 (depths 2, 2, 6, 2,
heads 1, 1, 2, 4, window 7), conv_dim 32, 16 bins, the zoo's 6 encoder
and 9 decoder layers, 224x224 frames (the textbook Swin needs every stage
a multiple of the window).

Tolerance: rtol 1e-4 with atol 1e-5 of the largest value (f32 on both
sides, the same sums in other orders).
"""
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from test_torch_textbook import (
    TMSDA, TPatchMerging, TSwinBlock, _center_reference_points,
    sine_positional_encoding)

torch.set_num_threads(1)

EMBED, DEPTHS, HEADS, WINDOW = 16, (2, 2, 6, 2), (1, 1, 2, 4), 7
CH = (64, 16, 32, 64, 128)                # the zoo's 5-level pyramid
CD, NBINS, TRANS = 32, 16, (2, 3, 4)
ENC_L, DEC_L, ATT_HEADS, PTS, CLASSES = 6, 9, 8, 8, 25
MIN_D, MAX_D = 1e-3, 10.0
HW = (224, 224)


def close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=err_msg)


# ---- the Swin backbone without ground embedding ----------------------------

class TStage(nn.Module):
    def __init__(self, dim, depth, heads, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(
            [TSwinBlock(dim, heads, WINDOW, shift=(d % 2 == 1))
             for d in range(depth)])
        self.downsample = TPatchMerging(dim, 2 * dim) if downsample else None


class TPatchEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        self.projection = nn.Conv2d(3, EMBED, 4, 4)
        self.norm = nn.LayerNorm(EMBED, eps=1e-5)

    def forward(self, x):
        x = self.projection(x)
        hw = x.shape[2:]
        return self.norm(x.flatten(2).transpose(1, 2)), hw


class TSwin(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.patch_embed = TPatchEmbed()
        dims = [EMBED * 2 ** i for i in range(4)]
        self.stages = nn.ModuleList([TStage(dims[i], DEPTHS[i], HEADS[i],
                                            i < 3) for i in range(4)])
        for i in range(4):
            setattr(self, f"norm{i}", nn.LayerNorm(dims[i], eps=1e-5))

    def forward(self, rgb):
        outs = [F.relu(self.bn1(self.conv1(rgb)))]
        x, hw = self.patch_embed(rgb)
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x, hw)
            out = getattr(self, f"norm{i}")(x)
            outs.append(out.transpose(1, 2).reshape(x.shape[0], -1, *hw))
            if stage.downsample is not None:
                x, hw = stage.downsample(x, hw)
        return outs


# ---- the BinsFormer head (tests/test_parity_binsformer.py) -----------------

class TConvBNAct(nn.Module):
    """mmcv ConvModule(conv no-bias + BN + act)."""

    def __init__(self, cin, cout, k, act):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, 1, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = act

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class TFFNRelu(nn.Module):
    """mmcv FFN key layout: layers.0.0 / layers.1."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Sequential(nn.Linear(dim, hidden), nn.ReLU()),
            nn.Linear(hidden, dim)])

    def forward(self, x):
        return self.layers[1](self.layers[0](x))


class TEncLayer(nn.Module):
    """mmcv BaseTransformerLayer ('self_attn','norm','ffn','norm')."""

    def __init__(self):
        super().__init__()
        self.attentions = nn.ModuleList(
            [TMSDA(CD, ATT_HEADS, len(TRANS), PTS)])
        self.ffns = nn.ModuleList([TFFNRelu(CD, 1024)])
        self.norms = nn.ModuleList([nn.LayerNorm(CD), nn.LayerNorm(CD)])

    def forward(self, x, pe, ref, shapes):
        x = self.norms[0](self.attentions[0](x, x, pe, ref, shapes))
        return self.norms[1](x + self.ffns[0](x))


class TMHAWrap(nn.Module):
    """mmcv MultiheadAttention: pos added to q/k, raw value, +identity."""

    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(CD, ATT_HEADS, batch_first=True)

    def forward(self, q, k, v, qpos, kpos):
        out, _ = self.attn(q + qpos, k + kpos, v, need_weights=False)
        return q + out


class TDecLayer(nn.Module):
    """PixelTransformerDecoderLayer
    ('cross_attn','norm','self_attn','norm','ffn','norm')."""

    def __init__(self):
        super().__init__()
        self.attentions = nn.ModuleList([TMHAWrap(), TMHAWrap()])
        self.ffns = nn.ModuleList([TFFNRelu(CD, 2048)])
        self.norms = nn.ModuleList([nn.LayerNorm(CD) for _ in range(3)])

    def forward(self, q, qpos, mem, mem_pos):
        q = self.norms[0](self.attentions[0](q, mem, mem, qpos, mem_pos))
        q = self.norms[1](self.attentions[1](q, q, q, qpos, qpos))
        return self.norms[2](q + self.ffns[0](q))


class TMLP3(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Linear(dim, dim), nn.Linear(dim, dim), nn.Linear(dim, out)])

    def forward(self, x):
        x = F.relu(self.layers[0](x))
        x = F.relu(self.layers[1](x))
        return self.layers[2](x)


class TEncoderWrap(nn.Module):
    """PureMSDEnTransformer state-dict shape (level_embeds + encoder.layers;
    the learned reference_points Linear is unused in the encoder-only
    forward, transformer.py:1146)."""

    def __init__(self):
        super().__init__()
        self.level_embeds = nn.Parameter(torch.randn(len(TRANS), CD))
        self.reference_points = nn.Linear(CD, 2)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [TEncLayer() for _ in range(ENC_L)])


class TDecoderWrap(nn.Module):
    """PixelTransformerDecoder state-dict shape (shared heads)."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList([TDecLayer() for _ in range(DEC_L)])
        self.decoder_norm = nn.LayerNorm(CD)
        self.bins_embed = nn.Linear(CD, 1)
        self.mask_embed = TMLP3(CD, CD)
        self.class_embed = TMLP3(CD, CLASSES)


def _sine_pe(h, w):
    pe = sine_positional_encoding(h, w, CD // 2).reshape(h * w, CD)
    return torch.from_numpy(pe)[None]


class TBinsFormer(nn.Module):
    """Reference BinsFormerDecodeHead forward
    (binsformer_head.py:185-345), classify=True, binsformer=True."""

    def __init__(self):
        super().__init__()
        leaky = nn.LeakyReLU(0.01)
        self.skip_proj = nn.ModuleList(
            [TConvBNAct(CH[i], CD, 1, leaky) for i in TRANS])
        self.transformer_encoder = TEncoderWrap()
        # lateral/output_convs registered in top-down (coarse->fine) order
        # (binsformer_head.py:133-135 reverses before registration)
        fpn_in = list(CH[:len(TRANS)])[::-1]
        self.lateral_convs = nn.ModuleList(
            [TConvBNAct(c, CD, 1, nn.ReLU()) for c in fpn_in])
        self.output_convs = nn.ModuleList(
            [TConvBNAct(CD, CD, 3, leaky) for _ in fpn_in])
        self.level_embed = nn.Embedding(len(TRANS), CD)
        self.query_feat = nn.Embedding(NBINS + 1, CD)
        self.query_embed = nn.Embedding(NBINS + 1, CD)
        self.transformer_decoder = TDecoderWrap()

    def forward(self, inputs):
        # DMS encoder over trans_index levels
        feats = [proj(inputs[i]) for proj, i in zip(self.skip_proj, TRANS)]
        shapes = [(f.shape[2], f.shape[3]) for f in feats]
        toks, pes = [], []
        for i, f in enumerate(feats):
            B, _, H_, W_ = f.shape
            toks.append(f.flatten(2).transpose(1, 2))
            pes.append(_sine_pe(H_, W_)
                       + self.transformer_encoder.level_embeds[i][None,
                                                                  None])
        src = torch.cat(toks, 1)
        pe = torch.cat(pes, 1)
        ref = torch.from_numpy(_center_reference_points(shapes))[None]
        for layer in self.transformer_encoder.encoder.layers:
            src = layer(src, pe, ref, shapes)

        out = []
        start = 0
        for (H_, W_) in shapes:
            n = H_ * W_
            out.append(src[:, start:start + n].transpose(1, 2).reshape(
                -1, CD, H_, W_))
            start += n
        out = out[::-1]

        # FPN (top-down over index[:L] reversed), seeded by out[-1]
        for idx, f in enumerate(list(range(len(TRANS)))[::-1]):
            lat = self.lateral_convs[idx](inputs[f])
            y = lat + F.interpolate(out[-1], size=lat.shape[-2:],
                                    mode="bilinear", align_corners=True)
            out.append(self.output_convs[idx](y))
        per_pixel = out[-1]
        ms_feats = out[:len(TRANS)]

        srcs, poss = [], []
        for i, f in enumerate(ms_feats):
            H_, W_ = f.shape[2], f.shape[3]
            srcs.append(f.flatten(2).transpose(1, 2))
            poss.append(_sine_pe(H_, W_)
                        + self.level_embed.weight[i][None, None])

        B = per_pixel.shape[0]
        q = self.query_feat.weight[None].repeat(B, 1, 1)
        qpos = self.query_embed.weight[None].repeat(B, 1, 1)

        dec = self.transformer_decoder
        outs = []
        for idx, layer in enumerate(dec.layers):
            li = idx % len(TRANS)
            q = layer(q, qpos, srcs[li], poss[li])
            # forward_prediction_heads (transformer.py:1606-1630)
            o = dec.decoder_norm(q)
            cls_q, bin_q = o[:, 0], o[:, 1:]
            cls_logits = dec.class_embed(cls_q)
            bins = dec.bins_embed(bin_q).squeeze(2).softmax(1)
            widths = (MAX_D - MIN_D) * bins
            widths = F.pad(widths, (1, 0), value=MIN_D)
            edges = torch.cumsum(widths, 1)
            centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
            emb = dec.mask_embed(bin_q)
            logits = torch.einsum("bqc,bchw->bqhw", emb, per_pixel)
            probs = logits.softmax(1)
            depth = (probs * centers[:, :, None, None]).sum(1, keepdim=True)
            outs.append((depth, edges, cls_logits))
        return outs


class TBinsFormerDepther(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = TSwin()
        self.decode_head = TBinsFormer()

    def forward(self, rgb):
        return self.decode_head(self.backbone(rgb))


def textbook():
    """The oracle from torch seed 0, in eval mode, with BatchNorm statistics
    other than 0 and 1 (so that their conversion matters)."""
    torch.manual_seed(0)
    tm = TBinsFormerDepther().eval()
    for m in tm.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    return tm


def released(sd):
    """The released checkpoints' layout: the pixel decoder nested one level
    deeper (what `binsformer_release_remap` undoes)."""
    pre = "decode_head.transformer_decoder."
    return {(pre + "decoder." + k[len(pre):]) if k.startswith(pre) else k: v
            for k, v in sd.items()}


def load_converted(tm, path, release=False):
    """The textbook's `state_dict` as a reference `.pth` at `path` (in the
    released layout when `release`), loaded into a seeded `ZooDepther`
    'binsformer' at the oracle's widths through `convert/from_pth.py`;
    every key of the model comes from the file."""
    import dataclasses

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.convert.from_pth import convert_checkpoint_file

    sd = tm.state_dict()
    torch.save({"state_dict": released(sd) if release else sd}, path)
    cfg = dataclasses.replace(get_config("binsformer_nyu").model,
                              backbone_embed_dims=EMBED, head_channels=CD,
                              n_bins=NBINS)
    model, report = convert_checkpoint_file(
        str(path), cfg.build(generator=torch.Generator().manual_seed(1)),
        binsformer_release=release)
    assert report == {"unmapped_torch_keys": [], "missing_params": [],
                      "missing_stats": [], "unused_torch_keys": []}, report
    return model.eval()


def frames(seed=2, batch=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (batch, *HW, 3)).astype(np.float32))


@pytest.mark.parametrize("release", [False, True])
def test_textbook_head_through_from_pth(tmp_path, release):
    """Every decoder layer's depth (at the stem's /2), bin edges and class
    logits of the port's head against the oracle's, on the oracle's own
    pyramid of two 224x224 frames."""
    tm = textbook()
    model = load_converted(tm, tmp_path / "binsformer.pth", release)
    with torch.no_grad():
        feats = tm.backbone(frames().permute(0, 3, 1, 2))
        want = tm.decode_head(feats)
        got = model.decode_head(feats, all_layers=True)
    assert len(got) == len(want) == DEC_L
    for i, (g, (d, e, c)) in enumerate(zip(got, want)):
        assert g["depth"].shape == (2, 1, HW[0] // 2, HW[1] // 2)
        close(g["depth"], d, f"layer {i} depth")
        close(g["bin_edges"], e, f"layer {i} edges")
        close(g["class_logits"], c, f"layer {i} class logits")


def test_textbook_model_through_from_pth(tmp_path):
    """The whole model: the port's Swin pyramid against the oracle's, and
    the final depth, edges and class logits of `ZooDepther` on two frames
    against the oracle's last decoder layer."""
    tm = textbook()
    model = load_converted(tm, tmp_path / "binsformer.pth")
    img = frames(seed=3)
    with torch.no_grad():
        want_feats = tm.backbone(img.permute(0, 3, 1, 2))
        got_feats = model.backbone(img.permute(0, 3, 1, 2))
        d, e, c = tm(img.permute(0, 3, 1, 2))[-1]
        got = model(img)
    for i, (g, w) in enumerate(zip(got_feats, want_feats)):
        close(g, w, f"pyramid level {i}")
    close(got["depth"].permute(0, 3, 1, 2), d, "depth")
    close(got["bin_edges"], e, "edges")
    close(got["class_logits"], c, "class logits")
