"""OCR verifier trainer: the TrOCR encoder and the char-level decoder,
supervised on rendered glyphs.

Counterpart of ``diffute_tpu/train/ocr_train.py`` on one card.  The
encoder and decoder train together as one module (``encoder.*`` and
``decoder.*`` state_dict keys) in fp32 with the port's AdamW; the loss is
teacher forcing (``[start] + ids[:-1]`` predicts ``ids``), the fp32
cross-entropy over the non-PAD positions.  A step also reports the token
accuracy over those positions and the pre-clip gradient norm.  The step
draws no noise.  The trained encoder conditions stage-2 training through
its ``trocr/`` export, and encoder and decoder together are the eval CLI's
verifier (``trocr/`` and ``trocr_decoder/``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffute_tpu_torch.config import DiffUTEConfig, TrOCRConfig
from diffute_tpu_torch.models import TrOCREncoder
from diffute_tpu_torch.models.trocr_decoder import TrOCRDecoder, TrOCRDecoderConfig
from diffute_tpu_torch.text import trocr_normalize
from diffute_tpu_torch.train.state import Trainer
from diffute_tpu_torch.utils.device import configure_cuda_numerics, resolve_device

Batch = Mapping[str, Union[np.ndarray, torch.Tensor]]
PARTS = ("encoder", "decoder")


@dataclasses.dataclass(frozen=True)
class OCRModelConfig:
    encoder: TrOCRConfig
    decoder: TrOCRDecoderConfig


class OCRModel(nn.Module):
    """The verifier as one trained module."""

    def __init__(self, config: OCRModelConfig):
        super().__init__()
        self.encoder = TrOCREncoder(config.encoder)
        self.decoder = TrOCRDecoder(config.decoder)


def join_params(params: Mapping[str, Mapping[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """{"encoder": sd, "decoder": sd} -> one state_dict of :class:`OCRModel`."""
    return {f"{part}.{k}": v for part in PARTS for k, v in params[part].items()}


def split_params(state_dict: Mapping[str, torch.Tensor]
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The inverse of :func:`join_params`."""
    out: Dict[str, Dict[str, torch.Tensor]] = {part: {} for part in PARTS}
    for k, v in state_dict.items():
        part, name = k.split(".", 1)
        out[part][name] = v
    return out


class OCRTrainer(Trainer):
    """Holds the verifier and its train state on ``device``: the card by
    default (raises without one), the CPU only when asked.

    ``params`` is ``{"encoder": ViT state_dict, "decoder": TrOCRDecoder
    state_dict}``; both train in fp32 whatever ``config.trocr.dtype`` and
    ``mixed_precision`` say, as in the JAX package.  The batch is
    ``{"glyph_pixels": (B, S, S, 3) uint8, "target_ids": (B, L) int}``
    (``io.dataset.make_ocr_batch``)."""

    def __init__(self, config: DiffUTEConfig, dcfg: TrOCRDecoderConfig,
                 params: Mapping[str, Mapping[str, torch.Tensor]],
                 device="cuda", total_steps: Optional[int] = None):
        self.device = resolve_device(device)
        configure_cuda_numerics(self.device)
        self.bf16, self.dtype = False, torch.float32
        fp32 = torch.float32
        self.config = dataclasses.replace(
            config, trocr=dataclasses.replace(config.trocr, dtype=fp32))
        self.dcfg = dataclasses.replace(dcfg, dtype=fp32)
        self.model = self._init_trained(
            OCRModel, OCRModelConfig(self.config.trocr, self.dcfg),
            join_params(params), total_steps)
        self._accuracy = []

    def draw(self, batch: int) -> None:
        return None

    def loss_fn(self, micro: Batch, draw=None) -> torch.Tensor:
        """Teacher-forcing cross-entropy (fp32) over the non-PAD targets;
        the micro-batch's token accuracy is kept for :meth:`step`."""
        dcfg, dev = self.dcfg, self.device
        pixels = torch.as_tensor(micro["glyph_pixels"]).to(dev)
        ids = torch.as_tensor(micro["target_ids"]).to(dev).long()
        enc = self.model.encoder(trocr_normalize(pixels).permute(0, 3, 1, 2))
        start = torch.full((ids.shape[0], 1), dcfg.decoder_start_token_id,
                           dtype=ids.dtype, device=dev)
        logits = self.model.decoder(torch.cat([start, ids[:, :-1]], dim=1), enc)
        logp = F.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(-1, ids[..., None])[..., 0]
        mask = (ids != dcfg.pad_token_id).float()
        count = mask.sum().clamp_min(1.0)
        hits = (logits.argmax(-1) == ids).float() * mask
        self._accuracy.append(hits.sum().detach() / count)
        return -(picked * mask).sum() / count

    def step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One optimizer step: 0-d tensors ``{"loss", "grad_norm",
        "token_accuracy"}``."""
        self._accuracy = []
        metrics = super().step(batch, draws)
        metrics["token_accuracy"] = torch.stack(self._accuracy).mean()
        return metrics
