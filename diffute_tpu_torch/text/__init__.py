from diffute_tpu_torch.text.glyph import find_font, render_glyph
from diffute_tpu_torch.text.preprocess import trocr_normalize, trocr_preprocess_host

__all__ = ["find_font", "render_glyph", "trocr_normalize",
           "trocr_preprocess_host"]
