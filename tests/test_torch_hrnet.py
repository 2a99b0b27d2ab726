"""The port's HRNet against the JAX package's, on the CPU.

Seeded numpy variables for the JAX HRNet (`_random_variables`) with the
BatchNorm statistics calibrated on the input (`calibrate`: the running
statistics set to the batch's, as in a trained network; with uncalibrated
statistics the activations grow through the fuse sums to ~1e3 and f32
rounding dominates any comparison), carried to the port by
`state_dict_from_flax`. The pyramid at an even size (64x128) and an odd
one (75x125: /4 19x32, /8 10x16, /16 5x8, /32 3x4, where the fuse layers'
repeat-and-crop upsample differs from `F.interpolate(size=...)`), in eval
and train mode, and the BatchNorm statistics after the train forward.

Tolerances (`hold`): the port's f32 output within twice the JAX package's
own f32 distance from its float64 evaluation (`jax_f64`, under
`jax.enable_x64`) plus 1e-5 of the largest value, and within rtol 1e-4 of
the JAX f32 output with that atol and JAX's distance. The 60-odd
convolutions of the stem, stage 1 and the fuse chains round in different
orders on the two sides: up to ~5e-5 of the largest value at the /32
level, on either side. The float64 reference owes nothing to the port, so
a fault of the port cannot widen its own tolerance.

A textbook torch HRNet under mmcv's names (tests/test_parity_hrnet.py's,
copied here without JAX) loads into the port as it is and through the JAX
`convert_state_dict` into flax: the three pyramids agree to rtol 1e-4,
atol 1e-5; the port's `.pth` report lists the keys the JAX converter
leaves unmapped.
"""
import numpy as np
import pytest
import torch
import torch.nn as tnn
import jax
import jax.numpy as jnp

from gedepth_tpu_torch.convert import state_dict_from_flax
from gedepth_tpu_torch.convert.from_jax import flax_variables_from_state_dict

from test_torch_gedepth import _random_variables

torch.set_num_threads(1)

# tests/test_parity_hrnet.py's small clone of the w18 layout: multi-module
# stages, every transition kind, 1..3-step fuse down-chains
TEST_CFG = ((1, (2,), (16,)),
            (1, (2, 2), (8, 16)),
            (2, (2, 2, 2), (8, 16, 32)),
            (2, (2, 2, 2, 2), (8, 16, 32, 64)))
SIZES = [(64, 128), (75, 125)]


def calibrate(model, x):
    """Set every BatchNorm's running statistics to the batch statistics of
    `model`'s train-mode forward of `x` (momentum 1 for one forward), then
    eval mode."""
    bns = [m for m in model.modules() if isinstance(m, tnn.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    for m, mom in zip(bns, saved):
        m.momentum = mom
    return model.eval()


def jax_f64(apply, variables, *args, **kw):
    """`apply` on float64 copies of `variables` and of the numpy arguments,
    under `jax.enable_x64`: the float64 reference, which owes nothing to
    the port. Returns its outputs as float64 numpy."""
    def cast(x):
        return jnp.asarray(np.asarray(x, np.float64))

    with jax.enable_x64(True):
        out = apply(jax.tree.map(cast, variables),
                    *[cast(a) if isinstance(a, np.ndarray) else a
                      for a in args], **kw)
        return jax.tree.map(lambda x: np.asarray(x, np.float64),
                            jax.device_get(out))


def hold(got, want, ref, err_msg=""):
    """got (the port, f32) against want (the JAX package, f32) and ref
    (the JAX package in float64): the port within twice JAX's own distance
    from ref plus 1e-5 of the largest value, and within rtol 1e-4 of JAX
    with that atol and JAX's distance."""
    got, want, ref = (np.asarray(a, np.float64) for a in (got, want, ref))
    assert got.shape == want.shape == ref.shape, (err_msg, got.shape,
                                                  want.shape, ref.shape)
    atol = 1e-5 * float(np.abs(ref).max())
    jax_err = float(np.abs(want - ref).max())
    port_err = float(np.abs(got - ref).max())
    assert port_err <= 2 * jax_err + atol, (err_msg, port_err, jax_err)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=atol + 3 * jax_err, err_msg=err_msg)


def _nhwc(t):
    return t.detach().double().numpy().transpose(0, 2, 3, 1)


def _hrnet_pair(img, arch="w18"):
    """(JAX HRNet, its variables, the port's HRNet with them), the
    statistics calibrated on `img`."""
    from gedepth_tpu.models.hrnet import HRNet as JaxHRNet
    from gedepth_tpu_torch.models.hrnet import HRNet

    jmodel = JaxHRNet(arch=arch)
    variables = _random_variables(jmodel.init, jnp.asarray(img), seed=2)
    sd = state_dict_from_flax({"backbone": variables["params"]},
                              {"backbone": variables["batch_stats"]})
    tmodel = HRNet(arch)
    tmodel.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()},
                           strict=True)
    calibrate(tmodel, torch.from_numpy(img.transpose(0, 3, 1, 2).copy()))
    params, stats = flax_variables_from_state_dict(
        {f"backbone.{k}": v for k, v in tmodel.state_dict().items()})
    return jmodel, {"params": params["backbone"],
                    "batch_stats": stats["backbone"]}, tmodel


@pytest.mark.parametrize("size", SIZES, ids=["even", "odd"])
def test_hrnet_matches_jax(size):
    """w18: the four levels in eval and train mode and the statistics
    after the train forward."""
    img = np.random.default_rng(0).standard_normal(
        (2,) + size + (3,)).astype(np.float32)
    jmodel, variables, tmodel = _hrnet_pair(img)
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    want = jmodel.apply(variables, jnp.asarray(img))
    ref = jax_f64(jmodel.apply, variables, img)
    with torch.no_grad():
        got = tmodel(x)
    for level, (g, wnt, r, c) in enumerate(zip(got, want, ref,
                                               (18, 36, 72, 144))):
        assert g.shape[:2] == (2, c), g.shape
        hold(_nhwc(g), wnt, r, f"eval level {level}")

    want, mutated = jmodel.apply(variables, jnp.asarray(img), True,
                                 mutable=["batch_stats"])
    ref, ref_stats = jax_f64(jmodel.apply, variables, img, True,
                             mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        got = tmodel(x)
    for level, (g, wnt, r) in enumerate(zip(got, want, ref)):
        hold(_nhwc(g), wnt, r, f"train level {level}")
    jstats = state_dict_from_flax({}, {"backbone": mutated["batch_stats"]})
    rstats = state_dict_from_flax({}, {"backbone": ref_stats["batch_stats"]})
    gstats = tmodel.state_dict()
    keys = [k for k in jstats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(m, tnn.BatchNorm2d)
                                for m in tmodel.modules())
    for key in keys:
        hold(gstats[key[len("backbone."):]], jstats[key], rstats[key], key)


def test_upsample_nearest_repeats_and_crops():
    """The fuse layers' upsample at an odd target: from the /32 level of a
    375-row frame (12 rows) to its /4 level (94), row i takes row i // 8
    (repeat and crop), not floor(i·12/94) (F.interpolate, which differs
    from row 87 on); equal to the JAX function at the pyramid's steps."""
    from gedepth_tpu.models.hrnet import _upsample_nearest as jax_up
    from gedepth_tpu_torch.models.hrnet import upsample_nearest

    x = torch.arange(12.0).reshape(1, 1, 12, 1)
    got = upsample_nearest(x, (94, 1))[0, 0, :, 0]
    assert torch.equal(got, torch.arange(94) // 8 * 1.0)
    interp = torch.nn.functional.interpolate(x, size=(94, 1))[0, 0, :, 0]
    assert not torch.equal(got, interp)
    rng = np.random.default_rng(1)
    for (h, w), (oh, ow) in (((47, 156), (94, 311)), ((24, 78), (94, 311)),
                             ((12, 39), (94, 311)), ((12, 39), (47, 156)),
                             ((3, 4), (19, 32))):
        a = rng.standard_normal((2, 3, h, w)).astype(np.float32)
        want = jax_up(jnp.asarray(a.transpose(0, 2, 3, 1)), (oh, ow))
        got = upsample_nearest(torch.from_numpy(a), (oh, ow))
        assert np.array_equal(_nhwc(got), np.asarray(want, np.float64))


def _cbr(cin, cout, k=3, stride=1, relu=True):
    mods = [tnn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                       bias=False), tnn.BatchNorm2d(cout)]
    if relu:
        mods.append(tnn.ReLU(inplace=True))
    return tnn.Sequential(*mods)


class TBasic(tnn.Module):
    def __init__(self, cin, ch):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, ch, 3, padding=1, bias=False)
        self.bn1 = tnn.BatchNorm2d(ch)
        self.conv2 = tnn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(ch)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)) + x)


class TBottle(tnn.Module):
    def __init__(self, cin, planes):
        super().__init__()
        cout = planes * 4
        self.conv1 = tnn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(cout)
        self.downsample = (tnn.Sequential(
            tnn.Conv2d(cin, cout, 1, bias=False), tnn.BatchNorm2d(cout))
            if cin != cout else None)

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        return torch.relu(self.bn3(self.conv3(out)) + idn)


class THRModule(tnn.Module):
    """mmcv's HRModule: branches, then the full fusion with nearest
    upsampling and a ReLU after each sum."""

    def __init__(self, channels):
        super().__init__()
        n = len(channels)
        self.branches = tnn.ModuleList(
            tnn.Sequential(*[TBasic(channels[i], channels[i])
                             for _ in range(2)]) for i in range(n))
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(tnn.Sequential(
                        tnn.Conv2d(channels[j], channels[i], 1, bias=False),
                        tnn.BatchNorm2d(channels[i]),
                        tnn.Upsample(scale_factor=2 ** (j - i),
                                     mode="nearest")))
                elif j == i:
                    row.append(None)
                else:
                    row.append(tnn.Sequential(*[
                        _cbr(channels[j], channels[i] if k == i - j - 1
                             else channels[j], stride=2,
                             relu=k < i - j - 1) for k in range(i - j)]))
            fuse.append(tnn.ModuleList(row))
        self.fuse_layers = tnn.ModuleList(fuse)

    def forward(self, xs):
        xs = [b(x) for b, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            y = 0
            for j, x in enumerate(xs):
                y = y + (x if i == j else row[j](x))
            outs.append(torch.relu(y))
        return outs


class THRNet(tnn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.conv2 = tnn.Conv2d(64, 64, 3, stride=2, padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(64)
        planes1, cin, blocks = cfg[0][2][0], 64, []
        for _ in range(cfg[0][1][0]):
            blocks.append(TBottle(cin, planes1))
            cin = planes1 * 4
        self.layer1 = tnn.Sequential(*blocks)
        prev = (cin,)
        for s, (num_modules, _, channels) in enumerate(cfg[1:], start=2):
            trans = []
            for i, ch in enumerate(channels):
                if i < len(prev):
                    trans.append(_cbr(prev[i], ch) if prev[i] != ch
                                 else None)
                else:
                    trans.append(tnn.Sequential(
                        _cbr(prev[-1], ch, stride=2)))
            setattr(self, f"transition{s - 1}", tnn.ModuleList(trans))
            setattr(self, f"stage{s}", tnn.Sequential(
                *[THRModule(channels) for _ in range(num_modules)]))
            prev = channels

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in range(2, 5):
            trans = getattr(self, f"transition{s - 1}")
            xs = [(xs[j] if layer is None else layer(xs[j]))
                  if j < len(xs) else layer(xs[-1])
                  for j, layer in enumerate(trans)]
            xs = list(getattr(self, f"stage{s}")(xs))
        return xs


def _textbook():
    torch.manual_seed(0)
    model = THRNet(TEST_CFG).eval()
    for m in model.modules():
        if isinstance(m, tnn.BatchNorm2d):
            m.running_mean.uniform_(-0.3, 0.3)
            m.running_var.uniform_(0.7, 1.4)
    return model


def test_textbook_state_dict_loads_as_it_is():
    """The mmcv-named state dict into the port's HRNet with no key renamed
    (strict), and through the JAX converter into the flax HRNet: the
    textbook's, the port's and JAX's pyramids agree."""
    from gedepth_tpu.convert import convert_state_dict
    from gedepth_tpu.convert.torch_to_jax import _merge_into
    from gedepth_tpu.models.hrnet import HRNet as JaxHRNet, HRNET_CFGS
    from gedepth_tpu_torch.models.hrnet import HRNet

    book = _textbook()
    port = HRNet(TEST_CFG).eval()
    port.load_state_dict(book.state_dict(), strict=True)
    assert set(port.state_dict()) == set(book.state_dict())

    img = np.random.default_rng(0).standard_normal(
        (1, 64, 96, 3)).astype(np.float32)
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        want, got = book(x), port(x)
    params, stats, unmapped = convert_state_dict(
        {f"backbone.{k}": v.numpy() for k, v in book.state_dict().items()})
    assert not unmapped, unmapped[:8]
    HRNET_CFGS["torch_testcfg"] = TEST_CFG
    try:
        jmodel = JaxHRNet(arch="torch_testcfg")
        variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
        merged_p, missing_p = _merge_into(variables["params"],
                                          params["backbone"])
        merged_s, missing_s = _merge_into(variables["batch_stats"],
                                          stats["backbone"])
        assert not missing_p and not missing_s
        jouts = jmodel.apply({"params": merged_p, "batch_stats": merged_s},
                             jnp.asarray(img))
    finally:
        del HRNET_CFGS["torch_testcfg"]
    for level, (w, g, j) in enumerate(zip(want, got, jouts)):
        w, g = _nhwc(w), _nhwc(g)
        atol = 1e-5 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol,
                                   err_msg=f"port, level {level}")
        np.testing.assert_allclose(np.asarray(j), w, rtol=1e-4, atol=atol,
                                   err_msg=f"JAX, level {level}")


def test_pth_report_follows_the_jax_converter(tmp_path):
    """A reference `.pth` of the seg preset (the textbook's HRNet under
    `backbone.`, a few keys no rule maps) into the port's `SegOCRNet`:
    the backbone loads as it is, the heads keep their seeded weights, and
    the unmapped keys are the JAX converter's."""
    from gedepth_tpu.convert import convert_state_dict as jax_convert
    from gedepth_tpu_torch.convert.from_pth import convert_checkpoint_file
    from gedepth_tpu_torch.models.segmentation import SegOCRNet

    book = _textbook()
    sd = {f"backbone.{k}": v for k, v in book.state_dict().items()}
    w = sd["backbone.transition1.0.0.weight"]
    sd.update({
        # mmseg's own heads, a conv bias, a diagonal fuse layer and a
        # second step of a new branch: no rule of either converter
        "decode_head.0.conv_seg.weight": torch.zeros(2, 270, 1, 1),
        "decode_head.1.bottleneck.conv.weight": torch.zeros(4, 4, 3, 3),
        "backbone.conv1.bias": torch.zeros(64),
        "backbone.stage2.0.fuse_layers.0.0.0.weight": torch.zeros(8, 8, 1, 1),
        "backbone.transition1.1.1.0.weight": torch.zeros_like(w)})
    path = str(tmp_path / "ocrnet.pth")
    torch.save({"state_dict": sd}, path)

    model = SegOCRNet(backbone_arch=TEST_CFG, ocr_channels=64,
                      ocr_key_channels=32,
                      generator=torch.Generator().manual_seed(3))
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    _, _, jax_unmapped = jax_convert({k: v.numpy() for k, v in sd.items()})
    _, report = convert_checkpoint_file(path, model)
    assert sorted(report["unmapped_torch_keys"]) == sorted(jax_unmapped)
    assert len(jax_unmapped) == 5
    assert report["unused_torch_keys"] == []
    assert report["missing_params"] and all(
        k.startswith(("aux_head.", "ocr_head."))
        for k in report["missing_params"] + report["missing_stats"])
    got = model.state_dict()
    for k, v in book.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[f"backbone.{k}"], v), k
    for k in report["missing_params"]:
        assert torch.equal(got[k], seeded[k]), k
