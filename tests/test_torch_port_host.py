"""PyTorch port, host prep and scheduler: bit-for-bit against the JAX package.

The port re-implements the host side (glyph raster, 384^2 resize, mask,
masked image, crop window, uint8 resize, paste-back) without cv2 and
without importing the JAX package; on the same seeded inputs each must
give the same bytes as ``diffute_tpu``'s function.  The DDIM tables and
step must match JAX's fp32 arithmetic.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffute_tpu.config import GlyphConfig as JGlyphConfig
from diffute_tpu.config import SchedulerConfig as JSchedulerConfig
from diffute_tpu.config import TrOCRConfig as JTrOCRConfig
from diffute_tpu.diffusion import schedules as jsched
from diffute_tpu.io import hostops as jhostops
from diffute_tpu.pipeline import crop as jcrop
from diffute_tpu.pipeline import regions as jregions
from diffute_tpu.text import glyph as jglyph
from diffute_tpu.text import preprocess as jpre

from diffute_tpu_torch.config import GlyphConfig, SchedulerConfig, TrOCRConfig
from diffute_tpu_torch.diffusion import schedules as tsched
from diffute_tpu_torch.io import hostops
from diffute_tpu_torch.pipeline import crop as tcrop
from diffute_tpu_torch.pipeline import regions as tregions
from diffute_tpu_torch.text import glyph as tglyph
from diffute_tpu_torch.text import preprocess as tpre
from port_threads import torch_threads_per_worker  # noqa: F401

TEXTS = ["Hi", "", "DiffUTE 2026", "déjà vu", "x" * 17]


@pytest.mark.parametrize("text", TEXTS)
def test_glyph_and_384_resize_bitexact(text):
    ours = tglyph.render_glyph(text, GlyphConfig())
    ref = jglyph.render_glyph(text, JGlyphConfig())
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        tpre.trocr_preprocess_host([ours], TrOCRConfig()),
        jpre.trocr_preprocess_host([ref], JTrOCRConfig()))


def test_trocr_normalize_matches():
    x = np.random.RandomState(0).randint(0, 256, (2, 8, 8, 3), np.uint8)
    np.testing.assert_array_equal(
        tpre.trocr_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jpre.trocr_normalize(jnp.asarray(x))))


def _scenes(n=6, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        h, w = int(rng.randint(200, 900)), int(rng.randint(200, 1100))
        bw, bh = int(rng.randint(8, w // 2)), int(rng.randint(6, h // 3))
        x1, y1 = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
        yield rng.randint(0, 256, (h, w, 3), np.uint8), np.int32(
            [x1, y1, x1 + bw, y1 + bh])


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_masked_and_crop_window_bitexact(seed):
    for image, box in _scenes(seed=seed):
        hw = image.shape[:2]
        mask = tregions.generate_mask(hw, box)
        np.testing.assert_array_equal(mask, jregions.generate_mask(hw, box))
        np.testing.assert_array_equal(tregions.make_masked_image(image, mask),
                                      jregions.make_masked_image(image, mask))
        assert tcrop.infer_crop_params(hw, box, np.random.default_rng(5)) == \
            jcrop.infer_crop_params(hw, box, np.random.default_rng(5))


@pytest.mark.parametrize("src_hw,dst", [((256, 256), 512), ((768, 768), 512),
                                        ((300, 410), 64), ((1000, 1000), 512)])
def test_uint8_resize_bitexact_with_jax_native(src_hw, dst):
    src = np.random.RandomState(1).randint(0, 256, src_hw + (3,), np.uint8)
    ours = hostops.resize_bilinear_u8(src, dst, dst)
    np.testing.assert_array_equal(
        ours, jhostops.resize_bilinear_u8(src, dst, dst, backend="native"))
    mask = (src[..., 0] > 128).astype(np.uint8)
    np.testing.assert_array_equal(
        hostops.resize_bilinear_u8(mask, dst, dst),
        jhostops.resize_bilinear_u8(mask, dst, dst, backend="native"))
    if src_hw[0] > dst:  # downscales: also equal to the product (cv2) path
        np.testing.assert_array_equal(ours, jhostops.resize_bilinear_u8(src, dst, dst))


@pytest.mark.parametrize("seed", [0, 1])
def test_paste_back_bitexact(seed):
    """cv2's generic INTER_LINEAR (IPP off) equals the numpy transcription
    on every scale; with IPP on, the product's exact-2x windows still do."""
    try:
        cv2.setUseOptimized(False)
        for image, box in _scenes(seed=seed):
            x_s, y_s, cs = jcrop.infer_crop_params(image.shape[:2], box)
            edited = np.random.RandomState(seed).randint(
                0, 256, (512, 512, 3), np.uint8)
            np.testing.assert_array_equal(
                tcrop.paste_back(image, edited, x_s, y_s, cs, box),
                jcrop.paste_back(image, edited, x_s, y_s, cs, box))
    finally:
        cv2.setUseOptimized(True)
    image = np.random.RandomState(seed).randint(0, 256, (768, 1024, 3), np.uint8)
    box = np.int32([341, 256, 469, 298])  # bench.py's 512^2 box: 256 window
    x_s, y_s, cs = jcrop.infer_crop_params(image.shape[:2], box)
    assert cs == 256
    edited = np.random.RandomState(seed + 7).randint(0, 256, (512, 512, 3),
                                                      np.uint8)
    np.testing.assert_array_equal(
        tcrop.paste_back(image, edited, x_s, y_s, cs, box),
        jcrop.paste_back(image, edited, x_s, y_s, cs, box))


@pytest.mark.parametrize("beta_schedule", ["scaled_linear", "linear",
                                           "squaredcos_cap_v2"])
def test_schedule_tables_and_timesteps_match(beta_schedule):
    ours = tsched.make_schedule(SchedulerConfig(beta_schedule=beta_schedule))
    ref = jsched.make_schedule(JSchedulerConfig(beta_schedule=beta_schedule))
    for name in ("betas", "alphas", "alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for n in (5, 10, 50, 1000):
        np.testing.assert_array_equal(tsched.ddim_timesteps(ours, n),
                                      jsched.ddim_timesteps(ref, n))


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddim_step_matches(prediction_type):
    ours = tsched.make_schedule(SchedulerConfig(prediction_type=prediction_type))
    ref = jsched.make_schedule(JSchedulerConfig(prediction_type=prediction_type))
    rng = np.random.RandomState(2)
    ts = jsched.ddim_timesteps(ref, 50)
    prevs = list(ts[1:]) + [-1]
    for t, prev_t in list(zip(ts, prevs))[::7] + [(ts[-1], -1)]:
        x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
        eps = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
        out = tsched.ddim_step(ours, torch.from_numpy(eps), int(t), int(prev_t),
                               torch.from_numpy(x)).numpy()
        want = np.asarray(jsched.ddim_step(ref, jnp.asarray(eps), jnp.int32(t),
                                           jnp.int32(prev_t), jnp.asarray(x)))
        # same fp32 formula; XLA may contract a multiply-add, so allow a few
        # ulps of the result's scale (early steps divide by sqrt(a) ~ 0.07)
        np.testing.assert_allclose(out, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
