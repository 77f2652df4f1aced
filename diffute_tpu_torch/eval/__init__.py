from diffute_tpu_torch.eval.ocr import OCRVerifier
from diffute_tpu_torch.eval.quality import psnr, ssim

__all__ = ["OCRVerifier", "psnr", "ssim"]
