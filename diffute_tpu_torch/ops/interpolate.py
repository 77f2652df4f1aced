"""torch-``F.interpolate('nearest')``-compatible resize.

Counterpart of ``diffute_tpu/ops/interpolate.py``: the mask is downsampled
to latent resolution by sampling ``src = floor(dst * in / out)``, the first
pixel of each block, which is what the reference's
``F.interpolate(mode="nearest")`` does.
"""

from __future__ import annotations

import torch


def nearest_resize_2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W) or (B, H, W, C) -> same rank with (out_h, out_w) spatial dims."""
    h, w = x.shape[1], x.shape[2]
    iy = torch.arange(out_h, device=x.device) * h // out_h
    ix = torch.arange(out_w, device=x.device) * w // out_w
    return x[:, iy][:, :, ix]
