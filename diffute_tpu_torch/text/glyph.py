"""Host-side glyph rasterization (FreeType via PIL).

Counterpart of ``diffute_tpu/text/glyph.py``: the reference's ``draw_text``
(black text on a white ``((len+2)*40, 60)`` RGB canvas at (40, 10), font
size 40, empty text counted as length 3), LRU-cached.  The font search list
is the JAX package's, then DejaVu Sans shipped in ``text/fonts/`` (with its
license), so hosts without system fonts render the same face.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from diffute_tpu_torch.config import GlyphConfig

_HERE = os.path.dirname(os.path.abspath(__file__))
FALLBACK_FONTS = (
    "arialuni.ttf",
    os.path.join(_HERE, "..", "..", "assets", "arialuni.ttf"),
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    os.path.join(_HERE, "fonts", "DejaVuSans.ttf"),
)


@functools.lru_cache(maxsize=8)
def find_font(font_path: Optional[str], font_size: int) -> ImageFont.FreeTypeFont:
    candidates = (font_path,) + FALLBACK_FONTS if font_path else FALLBACK_FONTS
    for cand in candidates:
        if cand is None:
            continue
        try:
            return ImageFont.truetype(cand, font_size)
        except OSError:
            continue
    raise FileNotFoundError(
        f"No usable TTF font found (searched {candidates}); "
        "set GlyphConfig.font_path")


@functools.lru_cache(maxsize=4096)
def _render_cached(text: str, font_size: int, canvas_height: int, pos: tuple,
                   empty_text_len: int, font_path: Optional[str]) -> bytes:
    len_text = len(text) or empty_text_len
    img = Image.new("RGB", ((len_text + 2) * font_size, canvas_height),
                    color="white")
    draw = ImageDraw.Draw(img)
    draw.text(pos, text, font=find_font(font_path, font_size), fill="black")
    arr = np.array(img)
    return arr.tobytes() + arr.shape[1].to_bytes(4, "little")


def render_glyph(text: str, config: GlyphConfig = GlyphConfig()) -> np.ndarray:
    """Render ``text`` -> uint8 RGB array (canvas_height, (len+2)*font_size, 3)."""
    raw = _render_cached(text, config.font_size, config.canvas_height,
                         tuple(config.text_pos), config.empty_text_len,
                         config.font_path)
    width = int.from_bytes(raw[-4:], "little")
    arr = np.frombuffer(raw[:-4], dtype=np.uint8)
    return arr.reshape(config.canvas_height, width, 3).copy()
