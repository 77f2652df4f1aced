from diffute_tpu_torch.utils.device import resolve_device
from diffute_tpu_torch.utils.params import (
    build_meta,
    init_pipeline_params,
    load_module,
)

__all__ = ["build_meta", "init_pipeline_params", "load_module",
           "resolve_device"]
