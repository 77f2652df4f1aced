"""UI callback logic of the demo, on plain data (PyTorch port).

The port's own copy of ``diffute_tpu/serve/ui.py``: numpy and Pillow only,
so ``serve/web.py`` imports it without the JAX package.

The reference demo (app.ipynb:856-928) drives three affordances:
  - a two-click ROI state machine (``get_select_coordinates``,
    app.ipynb:860-884): the first click marks a point (highlighted as a
    small square, side 5% of the image height, labeled "Click second point
    for ROI"); the second click completes the sorted box (labeled
    "ROI of Text Editing");
  - four coordinate Number boxes (X0/Y0/X1/Y1) updated on every click;
  - an examples gallery seeding (text, image, steps, box) rows.

This module implements that logic on plain data so it is unit-testable
without a UI toolkit; ``serve/web.py`` binds it to HTTP.  Unlike the reference's module-global ``ROI_coordinates`` (shared
across concurrent users), state is an explicit dict that each user round-trips.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

ROI_LABEL = "ROI of Text Editing"
POINT_LABEL = "Click second point for ROI"
SAMPLERS = ("ddim", "ddpm", "dpmpp")

Box = Tuple[int, int, int, int]
Section = Tuple[Box, str]


def initial_roi_state() -> Dict[str, int]:
    return {"x_temp": 0, "y_temp": 0, "x_new": 0, "y_new": 0, "clicks": 0}


def select_coordinates(state: Dict[str, int], click_xy: Sequence[int],
                       image_hw: Tuple[int, int]):
    """Advance the two-click state machine by one click.

    Returns ``(new_state, sections, (x0, y0, x1, y1))`` where ``sections``
    is the AnnotatedImage overlay payload ([(box, label)]) and the box
    feeds the four Number widgets — exactly the reference's outputs
    (app.ipynb:864-884).
    """
    s = dict(state or initial_roi_state())
    s["clicks"] = s.get("clicks", 0) + 1
    # the reference always shifts: temp <- new, new <- click
    s["x_temp"], s["y_temp"] = s.get("x_new", 0), s.get("y_new", 0)
    s["x_new"], s["y_new"] = int(click_xy[0]), int(click_xy[1])
    if s["clicks"] % 2 == 0:
        box = (min(s["x_new"], s["x_temp"]), min(s["y_new"], s["y_temp"]),
               max(s["x_new"], s["x_temp"]), max(s["y_new"], s["y_temp"]))
        return s, [(box, ROI_LABEL)], box
    point_width = int(image_hw[0] * 0.05)  # 5% of image HEIGHT (shape[0])
    box = (s["x_new"], s["y_new"],
           s["x_new"] + point_width, s["y_new"] + point_width)
    return s, [(box, POINT_LABEL)], box


def roi_ready(state: Dict[str, int]) -> bool:
    """An edit needs a completed (even-click) box."""
    clicks = (state or {}).get("clicks", 0)
    return clicks >= 2 and clicks % 2 == 0


def run_edit(pipe, image: np.ndarray, text: str, steps,
             x0, y0, x1, y1,
             sampler: str = None) -> Tuple[np.ndarray, np.ndarray]:
    """The Generate-button callback body: the reference's ``text_editing``
    argument order (text, image, steps, x0, y0, x1, y1 -> image, mask;
    app.ipynb:653,927).  ``sampler`` is a beyond-reference knob
    ({ddim, ddpm, dpmpp}; None keeps the pipeline config)."""
    if image is None:
        raise ValueError("upload an image first")
    if not text:
        raise ValueError("enter the replacement text")
    box = (int(x0), int(y0), int(x1), int(y1))
    kwargs = {}
    if sampler:
        import dataclasses

        kwargs["edit_config"] = dataclasses.replace(pipe.config.edit,
                                                    sampler=sampler)
    return pipe.edit(np.asarray(image, dtype=np.uint8), box, text,
                     num_inference_steps=int(steps), **kwargs)


def make_examples(directory: str, seed: int = 0) -> List[list]:
    """Synthetic stand-ins for the reference's ./examples gallery
    (app.ipynb:905-912; those JPEGs are not redistributable).  Writes a few
    procedural document images and returns rows shaped like the reference's
    ``text_edit_examples``: [text, image_path, steps, x0, y0, x1, y1].
    """
    from diffute_tpu_torch.config import GlyphConfig
    from diffute_tpu_torch.io import hostops
    from diffute_tpu_torch.text import render_glyph

    os.makedirs(directory, exist_ok=True)
    specs = [("2023-07-25", 150), ("TPU", 150), ("88.88", 150), ("7890", 150)]
    gcfg = GlyphConfig()
    rows = []
    for k, (text, steps) in enumerate(specs):
        rng = np.random.default_rng((seed, k))
        h, w = 384, 512
        image = np.full((h, w, 3), int(rng.integers(200, 250)), np.uint8)
        glyph = render_glyph(text, gcfg)
        gh, gw = glyph.shape[:2]
        # size like SyntheticSceneDataset (io/dataset.py): strokes must stay
        # >= ~32 px tall to survive the VAE round-trip
        scale = min(1.0, (w * 0.7) / gw, (h * 0.25) / gh)
        gw2, gh2 = max(16, int(gw * scale)), max(16, int(gh * scale))
        x = int(rng.integers(10, w - gw2 - 10))
        y = int(rng.integers(10, h - gh2 - 10))
        image[y : y + gh2, x : x + gw2] = np.minimum(
            image[y : y + gh2, x : x + gw2],
            hostops.resize_bilinear_u8(glyph, gh2, gw2))
        path = os.path.join(directory, f"example_{k}.png")
        from PIL import Image

        Image.fromarray(image).save(path)
        rows.append([text, path, steps, x, y, x + gw2, y + gh2])
    return rows
