from diffute_tpu_torch.utils.params import build_meta, init_pipeline_params

__all__ = ["build_meta", "init_pipeline_params"]
