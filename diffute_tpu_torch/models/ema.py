"""Exponential moving average of the trained parameters.

Counterpart of ``diffute_tpu/models/ema.py`` (diffusers' ``EMAModel``): the
warm-up-aware decay ``min(max_decay, (1 + step) / (10 + step))``.  Unlike the
JAX package's functional ``ema_update``, :meth:`EmaState.update` changes the
shadow parameters in place (the JAX arrays are immutable; here a second
copy per step would only cost memory).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class EmaState:
    """Shadow copies of ``params`` (same order) and the update count."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.params: List[torch.Tensor] = [p.detach().clone() for p in params]
        self.step = 0

    @torch.no_grad()
    def update(self, new_params: Sequence[torch.Tensor],
               max_decay: float = 0.9999) -> None:
        """ema <- ema - (1 - decay) * (ema - p), in place."""
        self.step += 1
        decay = min(max_decay, (1.0 + self.step) / (10.0 + self.step))
        diff = torch._foreach_sub(self.params, list(new_params))
        torch._foreach_add_(self.params, diff, alpha=-(1.0 - decay))
