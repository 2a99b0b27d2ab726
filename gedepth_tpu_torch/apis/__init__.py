"""Serving APIs of the port: `inference` (init_depther, inference_depther)
and `export` (export_depther, load_exported). The names of `inference` load
on first use, so that `apis.export.load_exported` runs without the model
and config code."""

_INFERENCE = ("DeptherHandle", "cast_params_bf16", "inference_depther",
              "init_depther", "make_eval_step")


def __getattr__(name):
    if name in _INFERENCE:
        from gedepth_tpu_torch.apis import inference
        return getattr(inference, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
