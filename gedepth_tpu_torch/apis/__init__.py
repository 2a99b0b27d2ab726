from gedepth_tpu_torch.apis.inference import (  # noqa: F401
    DeptherHandle, cast_params_bf16, inference_depther, init_depther,
    make_eval_step)
