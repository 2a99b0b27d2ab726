"""The port's augmentations (`gedepth_tpu_torch.data.transforms`, on the
resamplers of `data.resample`) against `gedepth_tpu.data.transforms` and
cv2, on the CPU, with the same generator seeds.

Tolerances: crops, pads, flips and every nearest-resampled field exactly
equal, `valid_mask` included; bilinear RGB within 1e-3 on 0..255 (the
port's float32 blend against cv2's fused multiply-adds: ~5e-5); the raw-PE
channel, up to ±1e6, within rtol 1e-5 of the frame's largest |PE|; INTER_AREA
on uint8 within 1 grey level and equal at >= 99.9% of the pixels (a sum on
the rounding boundary may fall either way). A chain consumes the
generator's draws one for one: its state after a sample equals the JAX
chain's.
"""
import dataclasses

import cv2
import numpy as np
import pytest
import torch

from gedepth_tpu.data import transforms as jt
from gedepth_tpu_torch.data import resample
from gedepth_tpu_torch.data import transforms as tt

torch.set_num_threads(1)


def _cv2_multi(fn, img):
    """cv2 on <= 4 channels at a time, as the JAX transforms call it."""
    if img.ndim == 2 or img.shape[2] <= 4:
        return fn(img)
    parts = [fn(img[..., i:i + 4]) for i in range(0, img.shape[2], 4)]
    return np.concatenate([p[..., None] if p.ndim == 2 else p
                           for p in parts], axis=-1)


SHAPES = [(37, 61, 1.73), (120, 400, 0.57), (352, 1216, 1.37),
          (101, 333, 1.999), (64, 90, 0.5)]


@pytest.mark.parametrize("h,w,ratio", SHAPES)
def test_resizes_match_cv2(h, w, ratio):
    rng = np.random.default_rng(h)
    img = rng.uniform(0, 255, (h, w, 5)).astype(np.float32)
    size = (int(w * ratio), int(h * ratio))
    want = _cv2_multi(lambda a: cv2.resize(a, size,
                                           interpolation=cv2.INTER_LINEAR),
                      img)
    np.testing.assert_allclose(resample.resize_linear(img, size), want,
                               rtol=0, atol=1e-3)
    field = rng.integers(0, 11, (h, w)).astype(np.float32)
    np.testing.assert_array_equal(
        resample.resize_nearest(field, size),
        cv2.resize(field, size, interpolation=cv2.INTER_NEAREST))
    np.testing.assert_array_equal(
        resample.resize_nearest(img, size),
        _cv2_multi(lambda a: cv2.resize(a, size,
                                        interpolation=cv2.INTER_NEAREST),
                   img))


@pytest.mark.parametrize("h,w,th,tw", [(1216, 1936, 384, 640),
                                       (152, 242, 96, 160),
                                       (100, 170, 33, 57)])
def test_area_resize_matches_cv2(h, w, th, tw):
    rng = np.random.default_rng(w)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    smooth = cv2.GaussianBlur(noise, (0, 0), 2.0)
    for img in (noise, smooth):
        want = cv2.resize(img, (tw, th), interpolation=cv2.INTER_AREA)
        got = resample.resize_area_u8(img, (tw, th))
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    f = noise.astype(np.float32)
    np.testing.assert_allclose(
        resample.resize_area(f, (tw, th)),
        cv2.resize(f, (tw, th), interpolation=cv2.INTER_AREA),
        rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError):
        resample.resize_area(f, (w + 1, th))


@pytest.mark.parametrize("h,w,angle", [(352, 1216, 1.7), (704, 2432, -2.3),
                                       (200, 300, 0.37), (57, 83, -2.49),
                                       (96, 320, 2.5)])
def test_rotation_matches_cv2(h, w, angle):
    rng = np.random.default_rng(w)
    center = ((w - 1) * 0.5, (h - 1) * 0.5)
    M = cv2.getRotationMatrix2D(center, -angle, 1.0)
    np.testing.assert_array_equal(resample.rotation_matrix(center, -angle,
                                                           1.0), M)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    want = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR,
                          borderValue=0)
    np.testing.assert_allclose(resample.warp_affine(img, M, True, 0.0),
                               want, rtol=0, atol=1e-3)
    pe = rng.uniform(-1e6, 1e6, (h, w)).astype(np.float32)
    want = cv2.warpAffine(pe, M, (w, h), flags=cv2.INTER_LINEAR,
                          borderValue=0)
    np.testing.assert_allclose(resample.warp_affine(pe, M, True, 0.0), want,
                               rtol=0, atol=1e-5 * np.abs(pe).max())
    for border in (0.0, 255.0):
        field = rng.integers(0, 11, (h, w)).astype(np.float32)
        np.testing.assert_array_equal(
            resample.warp_affine(field, M, False, border),
            cv2.warpAffine(field, M, (w, h), flags=cv2.INTER_NEAREST,
                           borderValue=border))


def _sample(rng, h, w, mask=False, pe_range=1e6):
    img = rng.uniform(0, 255, (h, w, 5)).astype(np.float32)
    img[..., 3] = rng.uniform(0, 200, (h, w))
    img[..., 4] = rng.uniform(-pe_range, pe_range, (h, w))
    depth = rng.uniform(0, 80, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.7] = 0
    k = rng.integers(0, 11, (h, w)).astype(np.float32)
    k[depth == 0] = 255
    s = {"img": img, "depth_gt": depth, "pe_k_gt": k,
         "cam_height": np.float32(1.65)}
    if mask:
        s["valid_mask"] = (rng.random((h, w)) < 0.9).astype(np.float32)
    return s


def _copy(s):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in s.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        if key != "img":
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        np.testing.assert_allclose(g[..., :4], w[..., :4], rtol=0,
                                   atol=1e-3)
        if g.shape[-1] == 5:
            np.testing.assert_allclose(
                g[..., 4], w[..., 4], rtol=0,
                atol=1e-5 * max(np.abs(w[..., 4]).max(), 1.0))


TRANSFORMS = [
    ("KBCrop", lambda m: m.KBCrop(40, 96, crop_gt=True), False),
    ("KBCrop_img_only", lambda m: m.KBCrop(40, 96, crop_gt=False), False),
    ("RandomRatioResize", lambda m: m.RandomRatioResize((0.5, 2.0)), False),
    ("PadToSize", lambda m: m.PadToSize(80, 130), False),
    ("PadToSize_none", lambda m: m.PadToSize(30, 50), False),
    ("RandomRotate", lambda m: m.RandomRotate(0.5, 2.5), True),
    ("RandomFlip", lambda m: m.RandomFlip(0.5), True),
    ("RandomCrop", lambda m: m.RandomCrop((32, 64)), True),
    ("ColorAug", lambda m: m.ColorAug(0.5), False),
    ("ColorAug_ranges", lambda m: m.ColorAug(0.9, (0.5, 2.0), (0.7, 1.3),
                                             (0.6, 1.4)), False),
    ("Normalize", lambda m: m.Normalize(depth_scale=250.0), False),
    ("DDADResize", lambda m: m.DDADResize((24, 40)), False),
    ("DDADResize_img_only", lambda m: m.DDADResize((24, 40),
                                                   resize_gt=False), False),
]


@pytest.mark.parametrize("name,make,mask", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transform_matches_jax(name, make, mask):
    for seed in range(6):
        data = np.random.default_rng(100 + seed)
        sample = _sample(data, 61, 117, mask=mask)
        if name.startswith("DDAD"):
            sample["img"][..., :3] = np.round(sample["img"][..., :3])
        rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        got = make(tt)(_copy(sample), rt)
        want = make(jt)(_copy(sample), rj)
        _assert_same(got, want)
        assert rt.bit_generator.state == rj.bit_generator.state, name
    if name == "PadToSize":
        assert got["valid_mask"].sum() == 61 * 117


def test_ddad_resize_rgb_only_matches_jax():
    """A 3-channel image (no ground embedding) is area-resized in float."""
    rng = np.random.default_rng(7)
    img = np.round(rng.uniform(0, 255, (61, 117, 3))).astype(np.float32)
    got = tt.DDADResize((24, 40))({"img": img.copy()})["img"]
    want = jt.DDADResize((24, 40))({"img": img.copy()})["img"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def _chain_cfgs(dataset):
    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu_torch.configs import get_config

    name = f"gedepth_adaptive_{dataset}"
    over = (dict(eval_size=(40, 96), crop_size=(32, 64)) if dataset ==
            "kitti" else dict(ddad_resize=(40, 64), eval_size=(40, 64),
                              crop_size=(32, 48)))
    jcfg = jax_get_config(name)
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, **over))
    return dataclasses.replace(get_config(name).data, **over), jcfg


@pytest.mark.parametrize("dataset", ["kitti", "ddad"])
def test_train_chain_matches_jax(dataset):
    """The whole train chain over 20 seeds, on 5-channel frames with a
    sanitised raw PE: the same sample and the same draws consumed."""
    from gedepth_tpu.train.loop import build_train_pipeline as jax_chain
    from gedepth_tpu_torch.data import build_train_pipeline

    tdata, jcfg = _chain_cfgs(dataset)
    scale = jcfg.model.depth_scale
    port, ref = build_train_pipeline(tdata, scale), jax_chain(jcfg)
    padded = 0
    for seed in range(20):
        data = np.random.default_rng(1000 + seed)
        sample = _sample(data, 47 + seed % 3, 103 + 2 * seed, pe_range=1e6)
        sample["img"][..., :3] = np.round(sample["img"][..., :3])
        rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = port(_copy(sample), rt), ref(_copy(sample), rj)
        assert rt.bit_generator.state == rj.bit_generator.state, seed
        _assert_same(got, want)
        assert got["img"].shape[:2] == tuple(tdata.crop_size)
        padded += "valid_mask" in got
    assert 0 < padded < 20          # some ratios pad, some do not
