from diffute_tpu_torch.compat.from_jax import (
    pipeline_state_dicts,
    trocr_decoder_state_dict,
    trocr_state_dict,
    unet_state_dict,
    vae_state_dict,
)

__all__ = ["pipeline_state_dicts", "trocr_decoder_state_dict",
           "trocr_state_dict", "unet_state_dict", "vae_state_dict"]
