"""Crop-window policies and paste-back (numpy, host side).

Counterpart of ``diffute_tpu/pipeline/crop.py``: training picks a random
crop_scale=256 window around one OCR box (``train_crop``), inference an
adaptive window (``infer_crop_params``), and ``paste_back`` returns the
edited crop's box pixels to the original.  The port does not import cv2:
``train_crop``'s uint8 upscale goes through ``io.hostops.resize_bilinear_u8``
and ``paste_back``'s float resize is :func:`resize_linear_f32`, a numpy
transcription of cv2's float ``INTER_LINEAR`` (half-pixel centres, float32
weights, edge clamping).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from diffute_tpu_torch.io import hostops


@dataclasses.dataclass
class CropResult:
    image: np.ndarray         # cropped instance image (<= crop x crop)
    mask: np.ndarray          # cropped mask
    masked_image: np.ndarray  # cropped masked image
    x_s: int
    y_s: int
    crop_scale: int
    text: str                 # possibly truncated (train policy)


def _rescale_if_small(image: np.ndarray, mask: np.ndarray, masked: np.ndarray,
                      box: np.ndarray, crop_scale: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Upscale by int(2*crop/short_side) when the short side is below the
    crop window; the box is scaled with the image."""
    h, w = image.shape[:2]
    short_side = min(h, w)
    if short_side < crop_scale:
        scale = int(crop_scale * 2 / short_side)
        image, mask, masked = (hostops.resize_bilinear_u8(x, h * scale, w * scale)
                               for x in (image, mask, masked))
        box = box * scale
    return image, mask, masked, box


def train_crop(image: np.ndarray, mask: np.ndarray, masked: np.ndarray,
               box: np.ndarray, text: str, rng: np.random.Generator,
               crop_scale: int = 256) -> CropResult:
    """Random crop_scale^2 window containing (a prefix of) the box.

    Per axis, if the box fits, sample a window start in
    [max(0, end-crop), start), 0 on an empty range.  If the box exceeds the
    window, anchor at the box start and truncate the text proportionally."""
    image, mask, masked, box = _rescale_if_small(image, mask, masked, box,
                                                 crop_scale)
    x1, y1, x2, y2 = (int(v) for v in box)

    if x2 - x1 < crop_scale:
        lo = max(0, x2 - crop_scale)
        x_s = int(rng.integers(lo, x1)) if x1 > lo else 0
    else:
        x_s = x1
        text = text[: int(len(text) * crop_scale / (x2 - x1))]
    if y2 - y1 < crop_scale:
        lo = max(0, y2 - crop_scale)
        y_s = int(rng.integers(lo, y1)) if y1 > lo else 0
    else:
        y_s = y1
        text = text[: int(len(text) * crop_scale / (y2 - y1))]

    window = (slice(y_s, y_s + crop_scale), slice(x_s, x_s + crop_scale))
    return CropResult(image=image[window], mask=mask[window],
                      masked_image=masked[window], x_s=x_s, y_s=y_s,
                      crop_scale=crop_scale, text=text)

# The inference ladder: (6*char_height upper bound, window length).
_CROP_LADDER = (128, 256, 384, 512, 640, 784, 1000)


def infer_crop_params(image_hw: Tuple[int, int], box: np.ndarray,
                      rng: Optional[np.random.Generator] = None
                      ) -> Tuple[int, int, int]:
    """Adaptive inference crop: -> (x_s, y_s, crop_scale)."""
    h, w = image_hw
    short_side = min(h, w)
    x1, y1, x2, y2 = (int(v) for v in box)
    char_height = y2 - y1
    char_length = x2 - x1

    crop_length = None
    for bound in _CROP_LADDER:
        if 6 * char_height < bound:
            crop_length = max(bound, char_length)
            break
    if crop_length is None:
        crop_length = 6 * char_height

    crop_scale = (min(crop_length, short_side) if char_length < crop_length
                  else short_side)
    rng = rng or np.random.default_rng(0)

    if x2 - x1 < crop_scale:
        if x2 - crop_scale > 0:
            x_s = x2 - crop_scale
        elif x1 + crop_scale < w:
            x_s = x1
        else:
            x_s = 0
    else:
        hi = max(0, x2 - crop_scale - 1)
        x_s = int(rng.integers(x1, hi)) if hi > x1 else x1

    if y2 - y1 < crop_scale:
        if y2 - crop_scale > 0:
            y_s = y2 - crop_scale
        elif y1 + crop_scale < h:
            y_s = y1
        else:
            y_s = 0
    else:
        hi = max(0, y2 - crop_scale - 1)
        y_s = int(rng.integers(y1, hi)) if hi > y1 else y1

    return x_s, y_s, int(crop_scale)


def _linear_taps(src_len: int, dst_len: int, clamp_weights: bool):
    """cv2 INTER_LINEAR source indices and float32 weights along one axis.

    Like cv2's generic resize, taps past the edge are clamped to the edge
    pixel; along x the weight of a clamped tap also becomes (1, 0), along y
    only the row index is clamped."""
    scale = 1.0 / (dst_len / src_len)
    f = ((np.arange(dst_len) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp_weights:
        f[(i0 < 0) | (i0 >= src_len - 1)] = 0.0
    i1 = np.clip(i0 + 1, 0, src_len - 1)
    i0 = np.clip(i0, 0, src_len - 1)
    return i0, i1, np.float32(1.0) - f, f


def resize_linear_f32(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """float32 HWC (or HW) -> (dh, dw) with cv2's float INTER_LINEAR.

    Bit-identical to cv2's generic (non-IPP) path; cv2 builds with Intel
    IPP take another route for non-dyadic scales and differ in the last
    bits (tests/test_torch_port_host.py)."""
    src = np.asarray(src, np.float32)
    x0, x1, ax0, ax1 = _linear_taps(src.shape[1], dw, clamp_weights=True)
    y0, y1, by0, by1 = _linear_taps(src.shape[0], dh, clamp_weights=False)
    ext = (slice(None),) + (None,) * (src.ndim - 2)
    rows = src[:, x0] * ax0[ext] + src[:, x1] * ax1[ext]     # horizontal pass
    ext_y = (slice(None), None) + (None,) * (src.ndim - 2)
    return rows[y0] * by0[ext_y] + rows[y1] * by1[ext_y]      # vertical pass


def paste_back(original: np.ndarray, edited_crop: np.ndarray, x_s: int,
               y_s: int, crop_scale: int, box: np.ndarray) -> np.ndarray:
    """Resize the edited crop back into its window and paste ONLY the bbox
    pixels into a copy of the original."""
    h, w = original.shape[:2]
    r_h = h - y_s if y_s + crop_scale > h else crop_scale
    r_w = w - x_s if x_s + crop_scale > w else crop_scale

    x1, y1, x2, y2 = (int(v) for v in box)
    result = original.astype(np.uint8, copy=True)
    ry1, ry2 = max(y1, y_s), min(y2, y_s + r_h)
    rx1, rx2 = max(x1, x_s), min(x2, x_s + r_w)
    if ry2 > ry1 and rx2 > rx1:
        resized = resize_linear_f32(edited_crop, r_h, r_w)
        patch = resized[ry1 - y_s : ry2 - y_s, rx1 - x_s : rx2 - x_s]
        result[ry1:ry2, rx1:rx2] = np.clip(np.round(patch), 0, 255).astype(np.uint8)
    return result
