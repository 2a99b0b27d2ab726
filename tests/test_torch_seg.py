"""The port's seg model, train step and evaluator against the JAX package's,
on the CPU: `SegOCRNet` (HRNet-W18, head_channels 8: OCR widths 64 and 32)
at 64x128 and at 75x125, `ground_mask_labels`, three steps of
`SegEvaluator` on a seeded KITTI tree, the params-only `.npz` both ways
and the weight-decay mask (the train step and the CLI:
tests/test_torch_seg_train.py).

Weights: seeded numpy variables for the JAX model (`_random_variables`),
the BatchNorm statistics calibrated on the input (tests/test_torch_hrnet.py
`calibrate`; uncalibrated, the features reach ~5e2 and the OCR head's
softmaxes saturate, so f32 rounding decides which region a pixel attends
to), carried to the port by `state_dict_from_flax`.

Tolerances: the logits of both stages and the BatchNorm statistics as
tests/test_torch_hrnet.py holds the HRNet pyramid (`hold`: the port within
twice the JAX package's own f32 distance from its float64 evaluation plus
1e-5 of the largest value, and within rtol 1e-4 of JAX's f32 output with
that atol and JAX's distance). The evaluator's aggregates within 1e-6; the
labels bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import state_dict_from_flax
from gedepth_tpu_torch.convert.from_jax import flax_variables_from_state_dict

from test_torch_gedepth import _random_variables
from test_torch_hrnet import calibrate, hold, jax_f64

torch.set_num_threads(1)

PRESET = "ocrnet_hr18_kitti"
SHRINK = dict(head_channels=8)
H, W = 64, 128


def model_configs(**over):
    over = dict(SHRINK, **over)
    return (dataclasses.replace(jax_get_config(PRESET).model, **over),
            dataclasses.replace(get_config(PRESET).model, **over))


def image(size=(H, W), seed=0, batch=2):
    """A KITTI-like 5-channel input: normal RGB, clipped and raw PE."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((batch,) + size + (5,)).astype(np.float32)
    img[..., 3] = rng.uniform(0, 1, (batch,) + size)
    img[..., 4] = rng.uniform(2.0, 80.0, (batch,) + size)
    return img


def bridged(img, seed=1):
    """(JAX model, its variables, the port's model with them), the
    statistics calibrated on `img`."""
    jcfg, tcfg = model_configs()
    jmodel = jcfg.build()
    variables = _random_variables(jmodel.init, jnp.asarray(img), None,
                                  seed=seed)
    tmodel = tcfg.build()
    tmodel.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    calibrate(tmodel, torch.from_numpy(img))
    params, stats = flax_variables_from_state_dict(tmodel.state_dict())
    return jmodel, {"params": params, "batch_stats": stats}, tmodel


def test_config_builds_the_seg_model():
    """`ModelConfig(arch='seg').build()` is `SegOCRNet` (HRNet-W18, OCR
    512 and 256 at head_channels 64) with the JAX model's interface."""
    from gedepth_tpu_torch.configs import ModelConfig
    from gedepth_tpu_torch.models.segmentation import SegOCRNet

    from gedepth_tpu.configs import ModelConfig as JaxModelConfig

    model = ModelConfig(arch="seg").build()
    jmodel = JaxModelConfig(arch="seg").build()
    assert isinstance(model, SegOCRNet) and not model.training
    assert model.backbone.channels == (18, 36, 72, 144)
    assert model.aux_head.conv_seg.in_channels == 270
    assert model.ocr_head.bottleneck.conv.weight.shape == (512, 270, 3, 3)
    assert model.ocr_head.query_proj.weight.shape == (256, 512)
    assert model.ocr_head.conv_seg.bias.abs().max() == 0
    for attr in ("arch", "num_classes", "pe_variant", "min_depth",
                 "max_depth", "default_cam_height"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr


@pytest.mark.parametrize("size", [(H, W), (75, 125)], ids=["even", "odd"])
def test_seg_ocrnet_matches_jax(size):
    """Both stages' logits (NHWC at the input's size) in eval and train
    mode, and the BatchNorm statistics after the train forward."""
    img = image(size)
    jmodel, variables, tmodel = bridged(img)
    x = torch.from_numpy(img)
    want = jmodel.apply(variables, jnp.asarray(img))
    ref = jax_f64(jmodel.apply, variables, img)
    with torch.no_grad():
        got = tmodel(x)
    assert [k for k, v in got.items() if v is not None] == ["seg_logits"]
    for i, (g, w, r) in enumerate(zip(got["seg_logits"],
                                      want["seg_logits"],
                                      ref["seg_logits"])):
        assert g.shape == (2,) + size + (2,)
        hold(g.numpy(), w, r, f"eval stage {i}")

    want, mutated = jmodel.apply(variables, jnp.asarray(img), None, True,
                                 mutable=["batch_stats"])
    ref, ref_stats = jax_f64(jmodel.apply, variables, img, None, True,
                             mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        got = tmodel(x)
    for i, (g, w, r) in enumerate(zip(got["seg_logits"],
                                      want["seg_logits"],
                                      ref["seg_logits"])):
        hold(g.numpy(), w, r, f"train stage {i}")
    jstats = state_dict_from_flax({}, mutated["batch_stats"])
    rstats = state_dict_from_flax({}, ref_stats["batch_stats"])
    gstats = tmodel.state_dict()
    keys = [k for k in jstats if k.endswith(("running_mean", "running_var"))]
    assert set(keys) == {k for k in gstats
                         if k.endswith(("running_mean", "running_var"))}
    for key in keys:
        hold(gstats[key], jstats[key], rstats[key], key)


def test_ground_mask_labels_match_jax():
    """Bit for bit, with pixels on both sides of the 3% edge and GT 0."""
    from gedepth_tpu.train.steps import ground_mask_labels as jax_labels
    from gedepth_tpu_torch.train.steps import ground_mask_labels

    rng = np.random.default_rng(4)
    img = image(seed=4)
    gt = rng.uniform(1.0, 80.0, (2, H, W)).astype(np.float32)
    pe = gt * rng.uniform(0.95, 1.05, gt.shape).astype(np.float32)
    img[..., 3] = pe / 200.0
    gt[rng.uniform(size=gt.shape) < 0.3] = 0.0
    want = np.asarray(jax_labels(jnp.asarray(img), jnp.asarray(gt), 200.0))
    got = ground_mask_labels(torch.from_numpy(img), torch.from_numpy(gt),
                             200.0)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert 0.1 < want.mean() < 0.6


class _TorchStub(torch.nn.Module):
    """Logits that both packages compute to the bit: the input's first two
    channels (the normalised R and G), so the evaluators see the same
    classes and only their counting is compared."""
    num_classes = 2

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(2))

    def forward(self, img, cam_height=None):
        return {"seg_logits": [img[..., :2] * self.scale]}


def _jax_stub():
    import flax.linen as nn

    class JaxStub(nn.Module):
        num_classes: int = 2

        @nn.compact
        def __call__(self, img, cam_height=None, train=False):
            scale = self.param("scale", nn.initializers.ones, (2,))
            return {"seg_logits": [img[..., :2] * scale]}

    return JaxStub()


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """A seeded KITTI tree (120x400, 3 frames a date, seed 1: one of its
    two test frames holds ~1,000 ground-mask pixels) finished by the
    port's tools; the (train, test) split paths."""
    from gedepth_tpu_torch.tools.make_tree import make_kitti_tree
    from gedepth_tpu_torch.tools.preprocess_data_kitti import main

    root = str(tmp_path_factory.mktemp("kitti_seg"))
    splits = make_kitti_tree(root, size=(120, 400), frames=3, seed=1)
    main(["--data-root", root, "--split", splits["train"], "--workers", "1"])
    return root, splits


def tree_config(tree, package="port"):
    """The preset on `tree` at eval size 96x320 and crop 64x128,
    head_channels 8, in the port or the JAX package."""
    root, splits = tree
    cfg = (get_config if package == "port" else jax_get_config)(PRESET)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **SHRINK),
        data=dataclasses.replace(
            cfg.data, data_root=root, train_split=splits["train"],
            test_split=splits["test"], eval_size=(96, 320),
            crop_size=(64, 128)))


@pytest.mark.parametrize("max_images", [None, 1])
def test_seg_evaluator_matches_jax(kitti_tree, max_images):
    """`SegEvaluator` on the tree's test split (the KITTI GT reloaded at
    full resolution and KB-cropped, the labels from the pipeline's PE
    channel) against the JAX `SegEvaluator` on the same predictions:
    miou, acc and iou_cls0/1 within 1e-6."""
    from gedepth_tpu.eval.evaluator import SegEvaluator as JaxSegEvaluator
    from gedepth_tpu.train.loop import build_datasets as jax_datasets
    from gedepth_tpu_torch.eval import SegEvaluator
    from gedepth_tpu_torch.train.loop import build_eval_dataset

    cfg, jcfg = tree_config(kitti_tree), tree_config(kitti_tree, "jax")
    evaluator = SegEvaluator(_TorchStub(), build_eval_dataset(cfg), cfg.data)
    got, rows = evaluator.run(max_images=max_images)
    jstub = _jax_stub()
    variables = jstub.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 5)))
    want, _ = JaxSegEvaluator(jstub, jax_datasets(jcfg)[1], jcfg.data,
                              process_index=0, process_count=1).run(
        variables["params"], {}, max_images=max_images)
    assert rows == [] and list(got) == ["miou", "acc", "iou_cls0",
                                        "iou_cls1"]
    assert set(got) == set(want)
    for key, value in want.items():
        assert abs(got[key] - float(value)) <= 1e-6, key
    assert evaluator.images == (max_images or 2)
    if max_images is None:      # the second frame holds the ground's pixels
        assert 0 < got["iou_cls1"] < got["iou_cls0"] < 1


def test_seg_npz_both_ways(tmp_path):
    """The port's `.npz` loads in the JAX `load_params_only` as the very
    variables the port's weights came from, which the JAX model runs; a
    JAX `.npz` loads into the port strictly, bit for bit."""
    from gedepth_tpu.train import checkpoint as jckpt
    from gedepth_tpu_torch.train import checkpoint as tckpt

    img = image(batch=1)
    jmodel, variables, tmodel = bridged(img, seed=7)
    path = str(tmp_path / "jax.npz")
    jckpt.save_params_only(path, variables["params"],
                           variables["batch_stats"])
    _, tcfg = model_configs()
    loaded = tckpt.load_params_only(path, tcfg.build())
    for k, v in tmodel.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(loaded.state_dict()[k], v), k

    path = str(tmp_path / "port.npz")
    tckpt.save_params_only(path, tmodel)
    params, stats = jckpt.load_params_only(
        path, variables["params"], variables["batch_stats"])
    for tree, ref in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got = jax.tree_util.tree_flatten_with_path(tree)[0]
        want = jax.tree_util.tree_flatten_with_path(ref)[0]
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, g), (_, w) in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), p
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(img))
    assert [np.asarray(w).shape for w in want["seg_logits"]] == [
        (1, H, W, 2)] * 2


def test_seg_decay_mask_matches_jax():
    """`optim.decays` over the seg model's parameter names equals the JAX
    `decay_mask` over its tree (every parameter decays)."""
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu_torch.convert.from_jax import _torch_name
    from gedepth_tpu_torch.train import optim as toptim

    jcfg, tcfg = model_configs()
    variables = _random_variables(jcfg.build().init,
                                  jnp.zeros((1, H, W, 5)), None)
    mask = joptim.decay_mask(variables["params"])
    seen = {}
    for path, decayed in jax.tree_util.tree_flatten_with_path(mask)[0]:
        name = _torch_name([getattr(p, "key", str(p)) for p in path])
        seen[name] = bool(decayed)
        assert toptim.decays(name) == bool(decayed), name
    assert set(seen) == {n for n, _ in tcfg.build().named_parameters()}


def _rename_top(sd, names):
    """A state dict with its top-level module names replaced by `names`."""
    out = {}
    for key, value in sd.items():
        top, rest = key.split(".", 1)
        out[f"{names.get(top, top)}.{rest}"] = value
    return out


@pytest.mark.parametrize("kind", ["encoder_decoder", "cascade"])
def test_seg_wrappers_match_jax(kind):
    """`EncoderDecoderSeg` (an FCN head on the last level, two 3x3 convs and
    conv_cat) and `CascadeEncoderDecoderSeg` (an FCN head over the resized
    and concatenated levels, then an OCR head) on the small HRNet of
    tests/test_torch_hrnet.py, 3 classes, in train mode: every stage's
    logits and the statistics, held as above."""
    from gedepth_tpu.models import segmentation as jseg
    from gedepth_tpu.models.hrnet import HRNET_CFGS, HRNet as JaxHRNet
    from gedepth_tpu_torch.models import segmentation as tseg
    from gedepth_tpu_torch.models.hrnet import HRNet

    from test_torch_hrnet import TEST_CFG

    widths, idx = TEST_CFG[-1][2], (0, 1, 2, 3)
    img = image(seed=3)[..., :3].copy()
    HRNET_CFGS["torch_testcfg"] = TEST_CFG
    try:
        if kind == "encoder_decoder":
            jmodel = jseg.EncoderDecoderSeg(
                backbone=JaxHRNet(arch="torch_testcfg"),
                head=jseg.FCNHead(channels=16, num_classes=3, num_convs=2,
                                  in_index=-1, concat_input=True))
            tmodel = tseg.EncoderDecoderSeg(HRNet(TEST_CFG), tseg.FCNHead(
                widths, 16, 3, 2, -1, concat_input=True))
            names = {"aux_head": "head"}
            tops = {"backbone": "backbone", "head": "aux_head"}
        else:
            jmodel = jseg.CascadeEncoderDecoderSeg(
                backbone=JaxHRNet(arch="torch_testcfg"),
                first_head=jseg.FCNHead(channels=sum(widths), num_classes=3,
                                        num_convs=1, kernel_size=1,
                                        in_index=idx),
                cascade_heads=(jseg.OCRHead(channels=32, ocr_channels=16,
                                            num_classes=3, in_index=idx),))
            tmodel = tseg.CascadeEncoderDecoderSeg(
                HRNet(TEST_CFG),
                tseg.FCNHead(widths, sum(widths), 3, 1, idx, kernel_size=1),
                [tseg.OCRHead(widths, 32, 16, 3, idx)])
            names = {"aux_head": "first_head", "ocr_head": "cascade_heads.0"}
            tops = {"backbone": "backbone", "first_head": "aux_head",
                    "cascade_heads_0": "ocr_head"}
        variables = _random_variables(jmodel.init, jnp.asarray(img), seed=8)
        sd = state_dict_from_flax(
            {tops[k]: v for k, v in variables["params"].items()},
            {tops[k]: v for k, v in variables["batch_stats"].items()})
        tmodel.load_state_dict(_rename_top(sd, names), strict=True)
        want, mutated = jmodel.apply(variables, jnp.asarray(img), True,
                                     mutable=["batch_stats"])
        ref, ref_stats = jax_f64(jmodel.apply, variables, img, True,
                                 mutable=["batch_stats"])
    finally:
        del HRNET_CFGS["torch_testcfg"]
    tmodel.train()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    got, want, ref = ([got], [want], [ref]) if kind == "encoder_decoder" \
        else (got, want, ref)
    assert len(got) == len(want) == (1 if kind == "encoder_decoder" else 2)
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        assert g.shape == (2, H, W, 3)
        hold(g.numpy(), w, r, f"stage {i}")
    jstats = _rename_top(state_dict_from_flax(
        {}, {tops[k]: v for k, v in mutated["batch_stats"].items()}), names)
    rstats = _rename_top(state_dict_from_flax(
        {}, {tops[k]: v for k, v in ref_stats["batch_stats"].items()}),
        names)
    gstats = tmodel.state_dict()
    keys = [k for k in jstats if k.endswith(("running_mean", "running_var"))]
    assert keys
    for key in keys:
        hold(gstats[key], jstats[key], rstats[key], key)
