"""The port's command lines against the JAX tools' spellings, and the busy
time of `tools.benchmark`, on the CPU.

Each JAX tool's argument list goes through the JAX tool's own parser (its
`main` stopped at `parse_args`) and through the port's: every option both
have comes out equal, and the JAX spellings (`tools/export.py --checkpoint`,
`tools/compat_check.py --cpu`) land where the port keeps them;
`tools/convert_torch_checkpoint.py` with `--binsformer-release` too. `tools.train
--options model.swin_remat=false` turns Swin remat off. `tools.benchmark`
takes the device's busy time as the union of its activity intervals, and
reports a busy reading past the event time instead of clamping the idle
share to 0.
"""
import argparse
import json
import sys
import types

import pytest
import torch

from gedepth_tpu_torch.tools import benchmark as bench
from gedepth_tpu_torch.tools import compat_check as port_compat_check
from gedepth_tpu_torch.tools import convert_torch_checkpoint as port_convert
from gedepth_tpu_torch.tools import export as port_export


class _Parsed(Exception):
    pass


def _jax_namespace(module, argv, monkeypatch):
    """The namespace the JAX tool `module` parses from `argv`."""
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        m.setattr(sys, "argv", [module.__file__] + list(argv))
        with pytest.raises(_Parsed) as parsed:
            module.main()
    return vars(parsed.value.args[0])


EXPORT_ARGVS = (
    ["smoke_synthetic", "--checkpoint", "x.npz", "--output", "d"],
    ["smoke_synthetic", "--checkpoint", "x.npz", "--output", "d", "--bf16",
     "--no-flip-tta", "--batch", "2", "--height", "64", "--width", "128",
     "--self-check"],
    ["smoke_synthetic", "--output", "d"],
)


@pytest.mark.parametrize("argv", EXPORT_ARGVS)
def test_export_takes_the_jax_tools_arguments(argv, monkeypatch):
    import tools.export as jax_export

    want = _jax_namespace(jax_export, argv, monkeypatch)
    got = vars(port_export.parse_args(argv))
    assert set(want) - set(got) == {"platforms"}     # the TPU's lowering
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want if k in got} == {
        k: v for k, v in want.items() if k != "platforms"}
    if "--checkpoint" in argv:
        positional = list(argv)
        positional.remove("--checkpoint")
        assert vars(port_export.parse_args(positional)) == got


def test_export_refuses_two_checkpoints():
    with pytest.raises(SystemExit):
        port_export.parse_args(["smoke_synthetic", "a.npz", "--checkpoint",
                                "b.npz", "--output", "d"])


COMPAT_ARGVS = (
    ["x.npz", "--cpu"],
    ["x.npz", "--config", "gedepth_adaptive_kitti_parity", "--radii", "5,6",
     "--images", "1", "--seed", "3", "--budget", "2e-3", "--cpu"],
    ["x.npz", "--radii", "4,8"],
    ["x.npz", "--cpu", "--options", "model.embed_dims=32",
     "data.eval_size=64,128"],
)


@pytest.mark.parametrize("argv", COMPAT_ARGVS)
def test_compat_check_takes_the_jax_tools_arguments(argv, monkeypatch):
    import tools.compat_check as jax_compat_check

    want = _jax_namespace(jax_compat_check, argv, monkeypatch)
    got = vars(port_compat_check.parse_args(argv))
    shared = set(want) & set(got)
    assert shared == {"checkpoint", "config", "radii", "budget", "images",
                      "seed", "options"}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["device"] == ("cpu" if want["cpu"] else "cuda")


CONVERT_ARGVS = (
    ["ref.pth", "binsformer_nyu", "out.npz", "--binsformer-release"],
    ["ref.pth", "gedepth_adaptive_kitti", "out.npz", "--simipu",
     "--official-swin"],
    ["ref.pth", "gedepth_adaptive_kitti", "out.npz", "--official-swin",
     "--options", "model.embed_dims=32"],
)


@pytest.mark.parametrize("argv", CONVERT_ARGVS)
def test_convert_takes_the_jax_tools_arguments(argv, monkeypatch):
    """tools/convert_torch_checkpoint.py's arguments: every option comes
    out equal, `--binsformer-release` and `--simipu` among them; no JAX
    flag is missing."""
    import tools.convert_torch_checkpoint as jax_convert

    want = _jax_namespace(jax_convert, argv, monkeypatch)
    got = vars(port_convert.parse_args(argv))
    assert set(want) - set(got) == set()
    assert set(got) <= set(want)
    assert got == {k: v for k, v in want.items() if k in got}


@pytest.mark.parametrize("raw,want", [("false", False), ("False", False),
                                      ("true", True), ("TRUE", True)])
def test_train_options_switch_remat(raw, want, monkeypatch):
    import gedepth_tpu_torch.train.loop as loop
    from gedepth_tpu_torch.tools import train as train_cli

    seen = {}

    def fake_train(cfg, **kwargs):
        seen["cfg"] = cfg
        return None, None, {}

    monkeypatch.setattr(loop, "train", fake_train)
    train_cli.main(["smoke_synthetic", "--device", "cpu", "--options",
                    f"model.swin_remat={raw}"])
    cfg = seen["cfg"]
    assert cfg.model.swin_remat is want
    assert cfg.model.build().backbone.remat is want


def test_boolean_option_refuses_other_words():
    from gedepth_tpu_torch.configs import apply_options, get_config

    with pytest.raises(ValueError, match="swin_remat"):
        apply_options(get_config("smoke_synthetic"), ["model.swin_remat=no"])


def _events(spans, device_type):
    return [types.SimpleNamespace(
        device_type=device_type,
        time_range=types.SimpleNamespace(start=a, end=b)) for a, b in spans]


def test_busy_time_is_the_union_of_device_intervals():
    from torch.autograd import DeviceType

    # two streams overlapping on the device, a record nested in a kernel,
    # a gap, and host events that must not count
    device = _events([(0, 10), (5, 15), (6, 7), (20, 30), (29, 31)],
                     DeviceType.CUDA)
    host = _events([(0, 100)], DeviceType.CPU)
    assert bench.union_ms([(a, b) for a, b in [(0, 10), (5, 15)]]) == 0.015
    assert bench.busy_ms_of(device + host) == pytest.approx(0.026)
    # the summed durations, as the reading was taken before: 0.033 ms
    assert sum(e.time_range.end - e.time_range.start for e in device) == 33
    assert bench.busy_ms_of(host) == 0.0


def test_summary_reports_busy_past_events():
    """The DDAD windowed f32 serving reading of an earlier run (busy 45.3
    in 38.8 ms by events, 38.9 ms on the host): the record shows the busy
    time past the event time and a negative idle share."""
    runner = bench.Runner(run=None, cfg=types.SimpleNamespace(
        name="gedepth_adaptive_ddad_tpu",
        model=types.SimpleNamespace(swin_remat=True)), mode="serve",
        dtype="f32", shape=(384, 640), batch=1,
        device=torch.device("cuda"), context=None)
    record = bench.summarise(runner, 2, [38.8, 38.8], 2 * 38.9, 1,
                             busy_ms=45.3)
    assert record["busy_over_events"] == pytest.approx(45.3 / 38.8)
    assert record["device_idle_share"] == pytest.approx(1 - 45.3 / 38.9)
    assert record["device_idle_share"] < 0
    assert record["swin_remat"] is True
    json.dumps(record)
