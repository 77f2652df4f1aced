"""Image conversions on the device.

Counterpart of ``diffute_tpu/utils/images.py``'s ``device_to_unit_range``.
"""

from __future__ import annotations

import torch


def device_to_unit_range(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 [0, 255] -> ``dtype`` in [-1, 1]: ``(x / 255 - 0.5) / 0.5`` in
    fp32, then the cast.  Float input passes through (cast only)."""
    if x.dtype == torch.uint8:
        x = (x.float() / 255.0 - 0.5) / 0.5
    return x.to(dtype)
