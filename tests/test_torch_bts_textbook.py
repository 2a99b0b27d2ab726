"""The textbook BTS decode head as an oracle for the port, without JAX.

`TBTSHead` is the reference BTSHead (depth/models/decode_heads/
bts_head.py:11-247, scale_up=False, final_norm=False) written plainly, a
copy of the one in tests/test_parity_bts.py. Its `state_dict` is what a
reference `.pth` holds under `decode_head.`, so it feeds the converters of
both packages; this file imports neither JAX nor the JAX package.

Test, on the CPU: the textbook weights through the port's
`convert/from_pth.py` rules give the port's `BTSHead` the textbook's depth,
rtol 2e-4, atol 2e-4 (the JAX package's own acceptance in
tests/test_parity_bts.py). The textbook's aconv_sequence BatchNorm keeps
torch's eps 1e-5 where the heads of both packages take 1.1e-5, as in the
original; with running variances near 1 that moves the output by ~1e-6.
"""
import math

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F

torch.set_num_threads(1)

FEAT_CH = (8, 12, 16, 24, 32)
NF, MAX_DEPTH, MIN_DEPTH = 128, 10.0, 1e-3
HW = 64


class TAtrous(tnn.Module):
    def __init__(self, cin, cout, dilation, apply_bn_first=True):
        super().__init__()
        seq = tnn.Sequential()
        if apply_bn_first:
            seq.add_module("first_bn", tnn.BatchNorm2d(cin, momentum=0.01,
                                                       eps=1.1e-5))
        seq.add_module("aconv_sequence", tnn.Sequential(
            tnn.ReLU(),
            tnn.Conv2d(cin, cout * 2, 1, bias=False),
            tnn.BatchNorm2d(cout * 2, momentum=0.01),
            tnn.ReLU(),
            tnn.Conv2d(cout * 2, cout, 3, padding=dilation,
                       dilation=dilation, bias=False)))
        self.atrous_conv = seq

    def forward(self, x):
        return self.atrous_conv(x)


class TUpconv(tnn.Module):
    def __init__(self, cin, cout, ratio=2):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.ratio = ratio

    def forward(self, x):
        x = F.interpolate(x, scale_factor=self.ratio, mode="nearest")
        return F.elu(self.conv(x))


class TReduction(tnn.Module):
    def __init__(self, cin, cout, max_depth, is_final=False):
        super().__init__()
        self.max_depth, self.is_final = max_depth, is_final
        self.reduc = tnn.Sequential()
        while cout >= 4:
            if cout < 8:
                if is_final:
                    self.reduc.add_module("final", tnn.Sequential(
                        tnn.Conv2d(cin, 1, 1, bias=False), tnn.Sigmoid()))
                else:
                    self.reduc.add_module("plane_params",
                                          tnn.Conv2d(cin, 3, 1, bias=False))
                break
            self.reduc.add_module(f"inter_{cin}_{cout}", tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, bias=False), tnn.ELU()))
            cin, cout = cout, cout // 2

    def forward(self, x):
        x = self.reduc(x)
        if not self.is_final:
            theta = torch.sigmoid(x[:, 0]) * (math.pi / 3)
            phi = torch.sigmoid(x[:, 1]) * (math.pi * 2)
            dist = torch.sigmoid(x[:, 2]) * self.max_depth
            x = torch.stack([torch.sin(theta) * torch.cos(phi),
                             torch.sin(theta) * torch.sin(phi),
                             torch.cos(theta), dist], dim=1)
        return x


def t_lpg(plane_eq, r):
    p = torch.repeat_interleave(plane_eq, r, 2)
    p = torch.repeat_interleave(p, r, 3)
    n1, n2, n3, n4 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    B, _, h, w = plane_eq.shape
    u = (torch.arange(r).float().view(1, 1, r).repeat(B, h * r, w)
         - (r - 1) * 0.5) / r
    v = (torch.arange(r).float().view(1, r, 1).repeat(B, h, w * r)
         - (r - 1) * 0.5) / r
    return n4 / (n1 * u + n2 * v + n3)


class TBTSHead(tnn.Module):
    """Textbook reference BTSHead (bts_head.py:108-247), scale_up=False,
    final_norm=False."""

    def __init__(self, feat_ch, nf, max_depth, min_depth):
        super().__init__()
        self.max_depth, self.min_depth = max_depth, min_depth
        self.upconv5 = TUpconv(feat_ch[4], nf)
        self.bn5 = tnn.BatchNorm2d(nf, momentum=0.01, eps=1.1e-5)
        self.conv5 = tnn.Sequential(
            tnn.Conv2d(nf + feat_ch[3], nf, 3, padding=1, bias=False),
            tnn.ELU())
        self.upconv4 = TUpconv(nf, nf // 2)
        self.bn4 = tnn.BatchNorm2d(nf // 2, momentum=0.01, eps=1.1e-5)
        self.conv4 = tnn.Sequential(
            tnn.Conv2d(nf // 2 + feat_ch[2], nf // 2, 3, padding=1,
                       bias=False), tnn.ELU())
        self.bn4_2 = tnn.BatchNorm2d(nf // 2, momentum=0.01, eps=1.1e-5)
        self.daspp_3 = TAtrous(nf // 2, nf // 4, 3, apply_bn_first=False)
        self.daspp_6 = TAtrous(nf // 2 + nf // 4 + feat_ch[2], nf // 4, 6)
        self.daspp_12 = TAtrous(nf + feat_ch[2], nf // 4, 12)
        self.daspp_18 = TAtrous(nf + nf // 4 + feat_ch[2], nf // 4, 18)
        self.daspp_24 = TAtrous(nf + nf // 2 + feat_ch[2], nf // 4, 24)
        self.daspp_conv = tnn.Sequential(
            tnn.Conv2d(nf + nf // 2 + nf // 4, nf // 4, 3, padding=1,
                       bias=False), tnn.ELU())
        self.reduc8x8 = TReduction(nf // 4, nf // 4, max_depth)
        self.upconv3 = TUpconv(nf // 4, nf // 4)
        self.bn3 = tnn.BatchNorm2d(nf // 4, momentum=0.01, eps=1.1e-5)
        self.conv3 = tnn.Sequential(
            tnn.Conv2d(nf // 4 + feat_ch[1] + 1, nf // 4, 3, padding=1,
                       bias=False), tnn.ELU())
        self.reduc4x4 = TReduction(nf // 4, nf // 8, max_depth)
        self.upconv2 = TUpconv(nf // 4, nf // 8)
        self.bn2 = tnn.BatchNorm2d(nf // 8, momentum=0.01, eps=1.1e-5)
        self.conv2 = tnn.Sequential(
            tnn.Conv2d(nf // 8 + feat_ch[0] + 1, nf // 8, 3, padding=1,
                       bias=False), tnn.ELU())
        self.reduc2x2 = TReduction(nf // 8, nf // 16, max_depth)
        self.upconv1 = TUpconv(nf // 8, nf // 16)
        self.reduc1x1 = TReduction(nf // 16, nf // 32, max_depth,
                                   is_final=True)
        self.conv1 = tnn.Sequential(
            tnn.Conv2d(nf // 16 + 4, nf // 16, 3, padding=1, bias=False),
            tnn.ELU())
        self.conv_depth = tnn.Conv2d(nf // 16, 1, 3, padding=1)

    def _plane(self, reduc, x, r):
        eq = reduc(x)
        n = F.normalize(eq[:, :3], 2, 1)
        eq = torch.cat([n, eq[:, 3:]], 1)
        return (t_lpg(eq, r).unsqueeze(1) / self.max_depth)

    def forward(self, features):
        skip0, skip1, skip2, skip3, feat = features
        x = F.relu(feat)
        up5 = self.bn5(self.upconv5(x))
        i5 = self.conv5(torch.cat([up5, skip3], 1))
        up4 = self.bn4(self.upconv4(i5))
        cat4 = torch.cat([up4, skip2], 1)
        i4 = self.bn4_2(self.conv4(cat4))
        d3 = self.daspp_3(i4)
        c2 = torch.cat([cat4, d3], 1)
        d6 = self.daspp_6(c2)
        c3 = torch.cat([c2, d6], 1)
        d12 = self.daspp_12(c3)
        c4 = torch.cat([c3, d12], 1)
        d18 = self.daspp_18(c4)
        c5 = torch.cat([c4, d18], 1)
        d24 = self.daspp_24(c5)
        daspp = self.daspp_conv(
            torch.cat([i4, d3, d6, d12, d18, d24], 1))
        d8 = self._plane(self.reduc8x8, daspp, 8)
        d8_ds = F.interpolate(d8, scale_factor=0.25, mode="nearest")
        up3 = self.bn3(self.upconv3(daspp))
        i3 = self.conv3(torch.cat([up3, skip1, d8_ds], 1))
        d4 = self._plane(self.reduc4x4, i3, 4)
        d4_ds = F.interpolate(d4, scale_factor=0.5, mode="nearest")
        up2 = self.bn2(self.upconv2(i3))
        i2 = self.conv2(torch.cat([up2, skip0, d4_ds], 1))
        d2 = self._plane(self.reduc2x2, i2, 2)
        up1 = self.upconv1(i2)
        r1 = self.reduc1x1(up1)
        i1 = self.conv1(torch.cat([up1, r1, d2, d4, d8], 1))
        return F.relu(self.conv_depth(i1)) + self.min_depth


def textbook_head(seed=0):
    """A textbook head at FEAT_CH and NF with randomised BatchNorm running
    statistics (so the statistics' mapping is exercised), in eval mode."""
    torch.manual_seed(seed)
    head = TBTSHead(FEAT_CH, NF, MAX_DEPTH, MIN_DEPTH).eval()
    for m in head.modules():
        if isinstance(m, tnn.BatchNorm2d):
            m.running_mean.uniform_(-0.3, 0.3)
            m.running_var.uniform_(0.7, 1.4)
    return head


def pyramid(seed=0, batch=1):
    """The 5-level input of the head, NHWC float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, HW // s, HW // s, c)).astype(
        np.float32) for s, c in zip((2, 4, 8, 16, 32), FEAT_CH)]


def reference_state_dict(head):
    """The head's tensors under the reference's `decode_head.` keys."""
    return {f"decode_head.{k}": v for k, v in head.state_dict().items()}


def test_port_bts_head_matches_the_textbook_head():
    from gedepth_tpu_torch.convert.from_pth import convert_state_dict
    from gedepth_tpu_torch.models.bts import BTSHead

    head = textbook_head()
    feats = pyramid()
    kept, unmapped = convert_state_dict(reference_state_dict(head))
    assert not unmapped, unmapped[:8]
    port = BTSHead(FEAT_CH, NF, MAX_DEPTH, MIN_DEPTH).eval()
    port.load_state_dict({k[len("decode_head."):]: v
                          for k, v in kept.items()}, strict=False)
    missing = set(port.state_dict()) - {k[len("decode_head."):]
                                        for k in kept}
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    x = [torch.from_numpy(f.transpose(0, 3, 1, 2)) for f in feats]
    with torch.no_grad():
        want, got = head(x), port(x)
    assert got.shape == want.shape == (1, 1, HW, HW)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
