from gedepth_tpu_torch.convert.from_jax import (  # noqa: F401
    load_flax_variables, state_dict_from_flax, unstack_swin_params)
