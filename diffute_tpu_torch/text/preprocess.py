"""TrOCR glyph-image preprocessing.

Counterpart of ``diffute_tpu/text/preprocess.py``: the variable-width glyph
render is resized to 384x384 on the host (PIL bilinear, as HF's
ViTImageProcessor), then rescaled by 1/255 and normalized with
mean = std = 0.5 on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from PIL import Image

from diffute_tpu_torch.config import TrOCRConfig


def trocr_preprocess_host(images: Sequence[np.ndarray],
                          config: TrOCRConfig = TrOCRConfig()) -> np.ndarray:
    """List of uint8 HWC RGB glyph renders -> (B, size, size, 3) uint8."""
    size = config.image_size
    out = np.empty((len(images), size, size, 3), dtype=np.uint8)
    for i, im in enumerate(images):
        pil = Image.fromarray(np.asarray(im, dtype=np.uint8))
        out[i] = np.array(pil.resize((size, size), Image.BILINEAR))
    return out


def trocr_normalize(pixels_uint8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> fp32 in [-1, 1], same layout."""
    x = pixels_uint8.float() / 255.0
    return (x - 0.5) / 0.5
