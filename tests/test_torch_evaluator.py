"""The PyTorch port's `Evaluator` and evaluation CLI against the JAX
package, on the CPU.

`Evaluator.run` against the JAX `Evaluator` on the synthetic dataset and on
a KITTI-shaped dataset with full-resolution GT; its options (device metrics,
multi-ratio and slide modes, max_images, on_prediction); `tools.test` as a
subprocess on the CPU.

Smoke widths, the exact (bilinear) neck, seeded numpy variables carried over
by `load_flax_variables` (the `models` fixture of tests/test_torch_eval.py).
Tolerances: the evaluators' per-image metrics and aggregates rtol 2e-4 (a
prediction 1e-4 off moves a ratio of a pixel's depth by as much); device
metrics against numpy rtol 1e-5.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.core import metrics as tmetrics
from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
from gedepth_tpu_torch.eval import Evaluator

from test_torch_eval import H, W, models  # noqa: F401 (a fixture)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_synthetic_eval_split_matches_jax():
    from gedepth_tpu.data.synthetic import SyntheticGroundDataset as JaxDS

    for use_pe in (True, False):
        a = SyntheticGroundDataset(size=3, height=48, width=96, seed=1,
                                   use_pe=use_pe)[2]
        b = JaxDS(size=3, height=48, width=96, seed=1, use_pe=use_pe)[2]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["img"].shape[-1] == (5 if use_pe else 3)


class _KittiShaped:
    """Synthetic frames above the eval size with their GT behind `load_gt`
    at full resolution, as the KITTI dataset serves them."""

    def __init__(self, size, height, width):
        self._ds = SyntheticGroundDataset(size=size, height=height,
                                          width=width, seed=2)

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        s = dict(self._ds[i])
        del s["depth_gt"]
        return s

    def load_gt(self, i):
        return self._ds[i]["depth_gt"]


def _run_both(models, dataset, jdataset, data_cfg, jdata_cfg, **kw):
    from gedepth_tpu.eval.evaluator import Evaluator as JaxEvaluator

    jmodel, variables, tmodel = models
    want_agg, want_rows = JaxEvaluator(
        jmodel, jdataset, jdata_cfg, process_index=0, process_count=1,
        **kw).run(variables["params"], variables["batch_stats"])
    got_agg, got_rows = Evaluator(tmodel, dataset, data_cfg, **kw).run()
    assert list(got_agg) == list(want_agg) == list(tmetrics.METRIC_NAMES)
    assert len(got_rows) == len(want_rows) == len(dataset)
    np.testing.assert_allclose(np.asarray(got_rows, np.float64),
                               np.asarray(want_rows, np.float64), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(list(got_agg.values()),
                               list(want_agg.values()), rtol=2e-4)
    return got_agg, got_rows


def test_evaluator_matches_jax_on_the_synthetic_dataset(models):
    """3 frames at batch 2 (the last batch padded), flip-TTA, garg crop."""
    from gedepth_tpu.data.synthetic import SyntheticGroundDataset as JaxDS

    kw = dict(size=3, height=H, width=W, seed=1)
    agg, _ = _run_both(models, SyntheticGroundDataset(**kw), JaxDS(**kw),
                       get_config("smoke_synthetic").data,
                       jax_get_config("smoke_synthetic").data, batch_size=2)
    assert 0 < agg["abs_rel"] < 100 and 0 <= agg["a1"] <= 1


def test_evaluator_matches_jax_on_full_resolution_gt(models):
    """The KITTI route: input KB-cropped to the eval size, the GT reloaded
    at full resolution and KB-cropped, eigen crop."""
    dataset = _KittiShaped(2, H + 10, W + 14)
    over = dict(dataset="kitti", eval_size=(H, W), garg_crop=False,
                eigen_crop=True)
    _run_both(models, dataset, dataset,
              dataclasses.replace(get_config("smoke_synthetic").data, **over),
              dataclasses.replace(jax_get_config("smoke_synthetic").data,
                                  **over))


def test_evaluator_options(models):
    """Device metrics equal the numpy ones; max_images and on_prediction;
    multi-ratio and slide modes run and differ from the whole-image run;
    slide does not compose with ratios."""
    _, _, tmodel = models
    cfg = get_config("smoke_synthetic").data
    ds = SyntheticGroundDataset(size=3, height=H, width=W, seed=1)
    seen = {}
    agg, rows = Evaluator(tmodel, ds, cfg, batch_size=2).run(
        on_prediction=lambda i, p: seen.__setitem__(i, p.copy()))
    assert sorted(seen) == [0, 1, 2] and seen[0].shape == (H, W)
    dagg, drows = Evaluator(tmodel, ds, cfg, batch_size=2,
                            device_metrics=True).run()
    np.testing.assert_allclose(np.asarray(drows, np.float64),
                               np.asarray(rows, np.float64), rtol=1e-5)
    np.testing.assert_allclose(list(dagg.values()), list(agg.values()),
                               rtol=1e-5)
    _, two = Evaluator(tmodel, ds, cfg, batch_size=2).run(max_images=2)
    assert two == rows[:2]
    _, none = Evaluator(tmodel, ds, cfg).run(max_images=1,
                                             compute_metrics=False)
    assert none == []

    ms = Evaluator(tmodel, ds, cfg, ms_ratios=(0.75, 1.0))
    assert len(ms.eval_steps) == 2
    _, ms_rows = ms.run(max_images=1)
    slide = Evaluator(tmodel, ds, cfg, mode="slide", slide_tile=(64, 128))
    _, slide_rows = slide.run(max_images=1)
    for other in (ms_rows, slide_rows):
        assert np.isfinite(other[0]).all() and other[0] != rows[0]
    slide_cfg = dataclasses.replace(cfg, eval_mode="slide", crop_size=(64, 128))
    _, cfg_rows = Evaluator(tmodel, ds, slide_cfg).run(max_images=1)
    assert cfg_rows == slide_rows       # eval_mode and crop_size as defaults
    with pytest.raises(ValueError, match="compose"):
        Evaluator(tmodel, ds, cfg, mode="slide", ms_ratios=(0.75,))
    with pytest.raises(ValueError, match="eval mode"):
        Evaluator(tmodel, ds, cfg, mode="tiles")


@pytest.mark.parametrize("extra", [
    (), ("--aug-test", "--aug-ratios", "0.75,1.0", "--device-metrics"),
    ("--slide", "--slide-tile", "64,128", "--no-tta", "--batch-size", "2")])
def test_tools_test_runs_on_the_cpu(extra, tmp_path):
    """`python -m gedepth_tpu_torch.tools.test` end to end: the seeded
    initialisation, then the same weights through --state-dict."""
    cmd = [sys.executable, "-m", "gedepth_tpu_torch.tools.test",
           "smoke_synthetic", "--max-images", "2", "--device", "cpu", *extra]
    if not extra:
        path = tmp_path / "weights.pt"
        torch.save(get_config("smoke_synthetic").model.build(
            generator=torch.Generator().manual_seed(0)).state_dict(), path)
        cmd += ["--state-dict", str(path)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["images"] == 2 and result["config"] == "smoke_synthetic"
    for name in tmetrics.METRIC_NAMES:
        assert np.isfinite(result[name]), name
    if not extra:
        model = get_config("smoke_synthetic").model.build(
            generator=torch.Generator().manual_seed(0))
        from gedepth_tpu_torch.train.loop import build_eval_dataset
        cfg = get_config("smoke_synthetic")
        agg, _ = Evaluator(model, build_eval_dataset(cfg), cfg.data).run(
            max_images=2)
        np.testing.assert_allclose([result[n] for n in agg],
                                   list(agg.values()), rtol=1e-6)
