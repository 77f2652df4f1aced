"""OCR-box mask and masked-image construction (numpy, host side).

Counterpart of ``diffute_tpu/pipeline/regions.py``: the reference's
``process_location`` (the training box, extended down by a tenth of its
height), ``generate_mask`` (PIL rectangle, inclusive of both corners) and
``make_masked_image`` (``image * (mask < 0.5)``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def process_location(location: Sequence[float],
                     image_hw: Tuple[int, int]) -> np.ndarray:
    """[x1, y1, x2, y2] -> box extended down by h/10, clamped to the image
    bottom.  ``image_hw`` = (height, width)."""
    x1, y1, x2, y2 = (float(v) for v in location)
    y2 = min(y2 + (y2 - y1) / 10.0, image_hw[0] - 1)
    return np.int32([x1, y1, x2, y2])


def generate_mask(image_hw: Tuple[int, int], box: Sequence[int]) -> np.ndarray:
    """uint8 (h, w) mask, 1 inside the (inclusive) box, 0 outside."""
    h, w = image_hw
    mask = np.zeros((h, w), dtype=np.uint8)
    x1, y1, x2, y2 = (int(v) for v in box)
    x1, x2 = np.clip([x1, x2], 0, w - 1)
    y1, y2 = np.clip([y1, y2], 0, h - 1)
    mask[y1 : y2 + 1, x1 : x2 + 1] = 1
    return mask


def make_masked_image(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Zero the masked region of an HWC image."""
    return image * (mask < 0.5)[..., None]
