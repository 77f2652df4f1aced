from diffute_tpu_torch.models.trocr import TrOCREncoder
from diffute_tpu_torch.models.unet import UNet2DCondition, count_params
from diffute_tpu_torch.models.vae import AutoencoderKL, sample_latent

__all__ = ["AutoencoderKL", "TrOCREncoder", "UNet2DCondition",
           "count_params", "sample_latent"]
