from gedepth_tpu_torch.apis.inference import (  # noqa: F401
    DeptherHandle, inference_depther, init_depther, make_eval_step)
