"""Train state: trainable fp32 parameters, optimizer state, EMA, step.

Counterpart of ``diffute_tpu/train/state.py``.  The JAX state is an
immutable pytree replaced every step; this one is updated in place by the
trainer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from diffute_tpu_torch.models.ema import EmaState
from diffute_tpu_torch.train.optim import AdamW


@dataclasses.dataclass
class TrainState:
    names: List[str]              # state_dict keys, in ``params`` order
    params: List[torch.Tensor]    # fp32 master weights
    opt: AdamW                    # first and second moments, count
    step: int = 0
    ema: Optional[EmaState] = None

    def state_dict(self):
        """The master weights under their state_dict keys (no copy)."""
        return dict(zip(self.names, self.params))
