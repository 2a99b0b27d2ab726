"""Multi-process data parallelism on `torch.distributed` (`parallel.dist`)."""
from gedepth_tpu_torch.parallel.dist import (  # noqa: F401
    active, average_gradients, backend, barrier, broadcast_object, comm_device,
    global_sum, init_from_env, is_main, local_rows, rank, shutdown, world)
