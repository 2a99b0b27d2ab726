"""The port's DDRNet (`models.ddrnet.DualResNet`) against the JAX
package's, on the CPU.

Seeded numpy variables for the JAX DualResNet (`_random_variables`), the
BatchNorm statistics calibrated on the input as tests/test_torch_hrnet.py
does, carried to the port by `state_dict_from_flax` and back by
`flax_variables_from_state_dict`: the /8 output in eval and train mode and
the statistics after the train forward, held as the HRNet pyramid is
(`hold`: the port within twice the JAX package's own f32 distance from its
float64 evaluation plus 1e-5 of the largest value, and within rtol 1e-4 of
JAX's f32 output with that atol and JAX's distance), at DDRNet-23-slim's
widths and a small clone.

The textbook DDRNet of tests/test_parity_ddrnet.py under the reference's
names (copied here without JAX) loads into the port as it is and through
the JAX `convert_state_dict` into flax: the three outputs agree to rtol
1e-3, atol 5e-4 (that test's tolerance); the port's `.pth` rules report
the JAX converter's unmapped keys.
"""
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from gedepth_tpu_torch.convert import state_dict_from_flax
from gedepth_tpu_torch.convert.from_jax import flax_variables_from_state_dict

from test_torch_gedepth import _random_variables
from test_torch_hrnet import calibrate, hold, jax_f64

torch.set_num_threads(1)

# tests/test_parity_ddrnet.py's small clone
PLANES, SPP, OUTP = 8, 16, 32
LAYERS = (2, 2, 2, 2)


class TBasic(tnn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=None,
                 no_relu=False):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, planes, 3, stride=stride, padding=1,
                                bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.downsample = downsample
        self.no_relu = no_relu

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out)) + r
        return out if self.no_relu else torch.relu(out)


class TBottle(tnn.Module):
    expansion = 2

    def __init__(self, cin, planes, stride=1, downsample=None,
                 no_relu=True):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, stride=stride,
                                padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, planes * 2, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(planes * 2)
        self.downsample = downsample
        self.no_relu = no_relu

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out)) + r
        return out if self.no_relu else torch.relu(out)


def _make_layer(block, cin, planes, blocks, stride=1):
    down = None
    if stride != 1 or cin != planes * block.expansion:
        down = tnn.Sequential(
            tnn.Conv2d(cin, planes * block.expansion, 1, stride=stride,
                       bias=False),
            tnn.BatchNorm2d(planes * block.expansion))
    mods = [block(cin, planes, stride, down)]
    cin = planes * block.expansion
    for i in range(1, blocks):
        mods.append(block(cin, planes, no_relu=(i == blocks - 1)))
    return tnn.Sequential(*mods)


def _bnconv(cin, cout, k=1, pool=None):
    mods = [] if pool is None else [pool]
    mods += [tnn.BatchNorm2d(cin), tnn.ReLU(inplace=True),
             tnn.Conv2d(cin, cout, k, padding=k // 2, bias=False)]
    return tnn.Sequential(*mods)


class TDAPPM(tnn.Module):
    def __init__(self, cin, bp, cout):
        super().__init__()
        self.scale1 = _bnconv(cin, bp, pool=tnn.AvgPool2d(5, 2, 2))
        self.scale2 = _bnconv(cin, bp, pool=tnn.AvgPool2d(9, 4, 4))
        self.scale3 = _bnconv(cin, bp, pool=tnn.AvgPool2d(17, 8, 8))
        self.scale4 = _bnconv(cin, bp, pool=tnn.AdaptiveAvgPool2d((1, 1)))
        self.scale0 = _bnconv(cin, bp)
        for i in range(1, 5):
            setattr(self, f"process{i}", _bnconv(bp, bp, 3))
        self.compression = _bnconv(bp * 5, cout)
        self.shortcut = _bnconv(cin, cout)

    def forward(self, x):
        hw = x.shape[-2:]
        xs = [self.scale0(x)]
        for i in range(1, 5):
            s = getattr(self, f"scale{i}")(x)
            s = F.interpolate(s, size=hw, mode="bilinear") + xs[-1]
            xs.append(getattr(self, f"process{i}")(s))
        return self.compression(torch.cat(xs, 1)) + self.shortcut(x)


class TDDR(tnn.Module):
    def __init__(self, layers=LAYERS, planes=PLANES, spp_planes=SPP,
                 out_planes=OUTP):
        super().__init__()
        hp = planes * 2
        self.conv1 = tnn.Sequential(
            tnn.Conv2d(3, planes, 3, stride=2, padding=1),
            tnn.BatchNorm2d(planes), tnn.ReLU(inplace=True),
            tnn.Conv2d(planes, planes, 3, stride=2, padding=1),
            tnn.BatchNorm2d(planes), tnn.ReLU(inplace=True))
        self.relu = tnn.ReLU(inplace=False)
        self.layer1 = _make_layer(TBasic, planes, planes, layers[0])
        self.layer2 = _make_layer(TBasic, planes, planes * 2, layers[1], 2)
        self.layer3_1 = _make_layer(TBasic, planes * 2, planes * 4,
                                    layers[2] // 2, 2)
        self.layer3_2 = _make_layer(TBasic, planes * 4, planes * 4,
                                    layers[2] // 2)
        self.layer4 = _make_layer(TBasic, planes * 4, planes * 8,
                                  layers[3], 2)
        for tag in ("3_1", "3_2"):
            setattr(self, f"compression{tag}", tnn.Sequential(
                tnn.Conv2d(planes * 4, hp, 1, bias=False),
                tnn.BatchNorm2d(hp)))
            setattr(self, f"down{tag}", tnn.Sequential(
                tnn.Conv2d(hp, planes * 4, 3, stride=2, padding=1,
                           bias=False),
                tnn.BatchNorm2d(planes * 4)))
        self.compression4 = tnn.Sequential(
            tnn.Conv2d(planes * 8, hp, 1, bias=False), tnn.BatchNorm2d(hp))
        self.down4 = tnn.Sequential(
            tnn.Conv2d(hp, planes * 4, 3, stride=2, padding=1, bias=False),
            tnn.BatchNorm2d(planes * 4), tnn.ReLU(inplace=True),
            tnn.Conv2d(planes * 4, planes * 8, 3, stride=2, padding=1,
                       bias=False),
            tnn.BatchNorm2d(planes * 8))
        self.layer3_1_ = _make_layer(TBasic, planes * 2, hp,
                                     layers[2] // 2)
        self.layer3_2_ = _make_layer(TBasic, hp, hp, layers[2] // 2)
        self.layer4_ = _make_layer(TBasic, hp, hp, layers[3])
        self.layer5_ = _make_layer(TBottle, hp, hp, 1)
        self.layer5 = _make_layer(TBottle, planes * 8, planes * 8, 1, 2)
        self.spp = TDAPPM(planes * 16, spp_planes, planes * 4)
        self.out_conv = tnn.Sequential(
            tnn.Conv2d(planes * 4, out_planes, 1, bias=False),
            tnn.BatchNorm2d(out_planes), tnn.ReLU())

    def forward(self, x):
        hw = (x.shape[-2] // 8, x.shape[-1] // 8)
        x = self.conv1(x)
        x = self.layer1(x)
        l1 = x
        x = self.layer2(self.relu(x))
        l2 = x
        x = self.layer3_1(self.relu(x))
        l3_1 = x
        xh = self.layer3_1_(self.relu(l2))
        x = x + self.down3_1(self.relu(xh))
        xh = xh + F.interpolate(self.compression3_1(self.relu(l3_1)),
                                size=hw, mode="bilinear")
        x = self.layer3_2(self.relu(x))
        l3_2 = x
        xh = self.layer3_2_(self.relu(xh))
        x = x + self.down3_2(self.relu(xh))
        xh = xh + F.interpolate(self.compression3_2(self.relu(l3_2)),
                                size=hw, mode="bilinear")
        x = self.layer4(self.relu(x))
        l4 = x
        xh = self.layer4_(self.relu(xh))
        x = x + self.down4(self.relu(xh))
        xh = xh + F.interpolate(self.compression4(self.relu(l4)),
                                size=hw, mode="bilinear")
        xh = self.layer5_(self.relu(xh))
        x = F.interpolate(self.spp(self.layer5(self.relu(x))), size=hw,
                          mode="bilinear")
        del l1
        return self.out_conv(x + xh)


def _nhwc(t):
    return t.detach().double().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("widths", [dict(), dict(layers=LAYERS, planes=PLANES,
                                                 spp_planes=SPP,
                                                 out_planes=OUTP)],
                         ids=["23-slim", "small"])
def test_dual_resnet_matches_jax(widths):
    """The /8 map in eval and train mode, the statistics after the train
    forward, and the flax tree back from the port's keys."""
    from gedepth_tpu.models.ddrnet import DualResNet as JaxDualResNet
    from gedepth_tpu_torch.models.ddrnet import DualResNet

    img = np.random.default_rng(0).standard_normal(
        (2, 128, 192, 3)).astype(np.float32)
    jmodel = JaxDualResNet(**widths)
    variables = _random_variables(jmodel.init, jnp.asarray(img), seed=4)
    sd = state_dict_from_flax({"backbone": variables["params"]},
                              {"backbone": variables["batch_stats"]})
    tmodel = DualResNet(**widths)
    tmodel.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()},
                           strict=True)
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    calibrate(tmodel, x)
    params, stats = flax_variables_from_state_dict(
        {f"backbone.{k}": v for k, v in tmodel.state_dict().items()})
    for tree, ref in ((params["backbone"], variables["params"]),
                      (stats["backbone"], variables["batch_stats"])):
        got = jax.tree_util.tree_flatten_with_path(tree)[0]
        want = jax.tree_util.tree_flatten_with_path(ref)[0]
        assert [p for p, _ in got] == [p for p, _ in want]
    variables = {"params": params["backbone"],
                 "batch_stats": stats["backbone"]}
    want = jmodel.apply(variables, jnp.asarray(img))
    ref = jax_f64(jmodel.apply, variables, img)
    with torch.no_grad():
        got = tmodel(x)
    assert got.shape == (2, widths.get("out_planes", 256), 16, 24)
    hold(_nhwc(got), want, ref, "eval")

    want, mutated = jmodel.apply(variables, jnp.asarray(img), True,
                                 mutable=["batch_stats"])
    ref, ref_stats = jax_f64(jmodel.apply, variables, img, True,
                             mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        got = tmodel(x)
    hold(_nhwc(got), want, ref, "train")
    jstats = state_dict_from_flax({}, {"backbone": mutated["batch_stats"]})
    rstats = state_dict_from_flax({}, {"backbone": ref_stats["batch_stats"]})
    gstats = tmodel.state_dict()
    keys = [k for k in jstats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(m, tnn.BatchNorm2d)
                                for m in tmodel.modules())
    for key in keys:
        hold(gstats[key[len("backbone."):]], jstats[key], rstats[key], key)


def _textbook():
    torch.manual_seed(0)
    model = TDDR().eval()
    for m in model.modules():
        if isinstance(m, tnn.BatchNorm2d):
            m.running_mean.uniform_(-0.3, 0.3)
            m.running_var.uniform_(0.7, 1.4)
    return model


def test_textbook_state_dict_loads_as_it_is():
    """The reference-named state dict into the port's DualResNet with no
    key renamed (strict), and through the JAX converter into flax."""
    from gedepth_tpu.convert import convert_state_dict
    from gedepth_tpu.convert.torch_to_jax import _merge_into
    from gedepth_tpu.models.ddrnet import DualResNet as JaxDualResNet
    from gedepth_tpu_torch.models.ddrnet import DualResNet

    book = _textbook()
    port = DualResNet(LAYERS, PLANES, SPP, OUTP).eval()
    port.load_state_dict(book.state_dict(), strict=True)
    img = np.random.default_rng(0).standard_normal(
        (1, 128, 192, 3)).astype(np.float32)
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        want, got = _nhwc(book(x)), _nhwc(port(x))
    params, stats, unmapped = convert_state_dict(
        {f"backbone.{k}": v.numpy() for k, v in book.state_dict().items()})
    assert not unmapped, unmapped[:8]
    jmodel = JaxDualResNet(layers=LAYERS, planes=PLANES, spp_planes=SPP,
                           out_planes=OUTP)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
    merged_p, missing_p = _merge_into(variables["params"], params["backbone"])
    merged_s, missing_s = _merge_into(variables["batch_stats"],
                                      stats["backbone"])
    assert not missing_p and not missing_s
    jout = np.asarray(jmodel.apply(
        {"params": merged_p, "batch_stats": merged_s}, jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(jout, want, rtol=1e-3, atol=5e-4)


def test_pth_rules_follow_the_jax_converter():
    """`from_pth.convert_state_dict` on the textbook's keys under
    `backbone.` and keys no DDRNet rule maps: the JAX converter's unmapped
    keys, `num_batches_tracked` dropped, every other key kept."""
    from gedepth_tpu.convert import convert_state_dict as jax_convert
    from gedepth_tpu_torch.convert.from_pth import convert_state_dict

    sd = {f"backbone.{k}": v for k, v in _textbook().state_dict().items()}
    sd.update({"backbone.conv1.1.extra": torch.zeros(1),
               "backbone.layer1.0.conv1.bias": torch.zeros(8),
               "backbone.spp.pool.0.weight": torch.zeros(1),
               "backbone.down4.2.weight": torch.zeros(1),
               "decode_head.conv_seg.weight": torch.zeros(2, 8, 1, 1)})
    kept, unmapped = convert_state_dict(sd)
    _, _, jax_unmapped = jax_convert({k: v.numpy() for k, v in sd.items()})
    assert sorted(unmapped) == sorted(jax_unmapped) and len(unmapped) == 5
    assert set(kept) == {k for k in sd if k not in unmapped
                         and not k.endswith("num_batches_tracked")}
