from gedepth_tpu_torch.eval.evaluator import Evaluator  # noqa: F401
