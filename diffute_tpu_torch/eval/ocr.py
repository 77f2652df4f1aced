"""OCR round-trip verification of edited regions.

Counterpart of ``diffute_tpu/eval/ocr.py``: the TrOCR encoder and causal
decoder read an edited region back, greedily; with a tokenizer (any object
with ``batch_decode``: ``text.CharTokenizer`` or a transformers tokenizer)
the read is a string compared with the requested text, without one the
token ids are returned.  The verifier runs in the configs' dtype (fp32 by
default) on ``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from diffute_tpu_torch.config import TrOCRConfig
from diffute_tpu_torch.models import TrOCREncoder
from diffute_tpu_torch.models.trocr_decoder import (
    TrOCRDecoder,
    TrOCRDecoderConfig,
    greedy_decode,
    greedy_decode_cached,
)
from diffute_tpu_torch.text import trocr_normalize, trocr_preprocess_host
from diffute_tpu_torch.utils.device import configure_cuda_numerics, resolve_device
from diffute_tpu_torch.utils.params import load_module


class OCRVerifier:
    """``encoder_params`` / ``decoder_params``: state_dicts with
    transformers' ViT and ``TrOCRForCausalLM`` (prefix stripped) keys."""

    def __init__(self, encoder_config: TrOCRConfig,
                 decoder_config: TrOCRDecoderConfig,
                 encoder_params: Mapping[str, torch.Tensor],
                 decoder_params: Mapping[str, torch.Tensor],
                 tokenizer=None, max_len: int = 32, use_cache: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        configure_cuda_numerics(self.device)
        self.encoder_config = encoder_config
        self.encoder = load_module(TrOCREncoder, encoder_config,
                                   dict(encoder_params), self.device,
                                   encoder_config.dtype)
        self.decoder = load_module(TrOCRDecoder, decoder_config,
                                   dict(decoder_params), self.device,
                                   decoder_config.dtype)
        self.tokenizer = tokenizer
        self.max_len = max_len
        self._decode = greedy_decode_cached if use_cache else greedy_decode

    def read(self, region_images: Sequence[np.ndarray]) -> np.ndarray:
        """uint8 HWC crops -> (B, max_len) int32 decoded token ids."""
        pixels = torch.from_numpy(
            trocr_preprocess_host(region_images, self.encoder_config))
        with torch.inference_mode():
            x = trocr_normalize(pixels.to(self.device)).permute(0, 3, 1, 2)
            enc = self.encoder(x.to(self.encoder_config.dtype))
            ids = self._decode(self.decoder, enc, self.max_len)
        return ids.cpu().numpy().astype(np.int32)

    def read_text(self, region_images: Sequence[np.ndarray]):
        if self.tokenizer is None:
            raise ValueError("read_text requires a tokenizer; use read() for ids")
        ids = self.read(region_images)
        return self.tokenizer.batch_decode(ids, skip_special_tokens=True)

    def verify(self, region_image: np.ndarray, expected_text: str,
               normalize=lambda s: "".join(s.split()).lower()) -> Optional[bool]:
        """True/False when a tokenizer is available; None otherwise."""
        if self.tokenizer is None:
            return None
        decoded = self.read_text([region_image])[0]
        return normalize(decoded) == normalize(expected_text)
