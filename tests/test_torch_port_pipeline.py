"""PyTorch port, the slice as a whole: the staged single-region edit against
the JAX package's staged programs, at tiny width with the flash route on.

Edit resolution 64 gives a 32x32 latent, so the UNet's top-level
self-attentions have 1024 tokens and take the flash entry on both sides
(JAX: the Pallas kernel in interpret mode; the port on the CPU: the kernel's
plain version).  Both sides get the same weights (through the bridge), the
same glyph, mask and masked crop, and the JAX key-tree noise draws
(tests/test_composed_parity.py's ``_pipeline_noise``).
"""

import dataclasses
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.pipeline import DiffUTEPipeline as JPipeline
from diffute_tpu.pipeline.regions import generate_mask, make_masked_image
from diffute_tpu.text import render_glyph, trocr_preprocess_host
from diffute_tpu.utils import init_pipeline_params as j_init

import diffute_tpu_torch.ops.attention as tattn
from diffute_tpu_torch.compat import pipeline_state_dicts
from diffute_tpu_torch.config import tiny_test_config
from diffute_tpu_torch.ops import flash_attention
from diffute_tpu_torch.pipeline import DiffUTEPipeline

# pytest puts tests/ itself on sys.path (conftest.py, prepend import mode)
from test_composed_parity import _pipeline_noise

RES, STEPS, SEED = 64, 10, 0


def _with_flash(cfg, res=RES):
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, use_flash_attention=True),
        edit=dataclasses.replace(cfg.edit, resolution=res))


@pytest.fixture(scope="module")
def pipes():
    jcfg = _with_flash(j_tiny())
    jparams = j_init(jcfg, seed=3)
    jpipe = JPipeline(jcfg, jparams)
    tpipe = DiffUTEPipeline(_with_flash(tiny_test_config()),
                            pipeline_state_dicts(jparams), device="cpu")
    return jpipe, tpipe


def _nchw(a):
    return torch.tensor(np.asarray(a).transpose(0, 3, 1, 2))


def test_staged_edit_matches_jax(pipes, monkeypatch):
    jpipe, tpipe = pipes
    rng = np.random.RandomState(11)
    image = rng.randint(0, 256, (RES, RES, 3), np.uint8)
    mask = generate_mask((RES, RES), np.int32([8, 12, 40, 30]))
    masked = make_masked_image(image, mask)
    glyph = trocr_preprocess_host([render_glyph("Hi", jpipe.config.glyph)],
                                  jpipe.config.trocr)

    # JAX: the staged programs edit() chains, the loop emitting every step
    dummy = jnp.zeros((1, 1, 1, 3), jnp.uint8)
    inputs = (dummy, jnp.asarray(mask[None]), jnp.asarray(masked[None]),
              jnp.asarray(glyph))
    jpipe._get_compiled(STEPS, "ddim", 1.0, False, 1)
    prep, _, _ = jpipe._stages[(STEPS, "ddim", 1.0, False, 1)]
    *prepped, k_loop = prep(jpipe.params, *inputs, dummy, np.int32(SEED))
    loop = jax.jit(functools.partial(jpipe._device_loop, STEPS, "ddim", 1.0,
                                     False, 1, return_trajectory=True))
    j_lat, j_traj = loop(jpipe.params["unet"], *prepped, k_loop)
    j_img = np.asarray(jpipe._decode(jpipe.params["vae"], j_lat))[0]
    j_traj = np.asarray(j_traj)

    # port: the same stages, fed the JAX draws
    r = RES // jpipe.config.vae.scale_factor  # 32: the flash route's 1024 tokens
    n_init, n_mask, *_ = _pipeline_noise(jpipe.config, SEED, STEPS, "ddim",
                                         (1, r, r, 4))
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash_attention(*a, **kw))
    launches = flash_attention.launches
    with torch.inference_mode():
        prepped = tpipe._device_prep(
            torch.from_numpy(mask[None]), torch.from_numpy(masked[None]),
            torch.from_numpy(glyph), _nchw(n_init), _nchw(n_mask))
        lat, traj = tpipe._device_loop(STEPS, *prepped, return_trajectory=True)
        img = tpipe._device_decode(lat)[0].numpy()

    # 3 self-attentions at 1024 tokens per UNet forward (down 0: 1, up 1: 2)
    # took the flash entry; on CPU tensors that is the plain version, so
    # the kernel launch count does not move
    assert len(calls) == 3 * STEPS
    assert flash_attention.launches == launches

    # per-step latents within 5e-3 of the running scale (fp32 on both
    # sides, different op order; early steps divide by sqrt(alpha_bar)),
    # the final image within 1 LSB — tests/test_composed_parity.py's bounds
    assert traj.shape[0] == STEPS
    for i in range(STEPS):
        ref = j_traj[i].transpose(0, 3, 1, 2)
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(traj[i].numpy() - ref).max())
        assert err <= 5e-3 * scale, f"step {i}: {err:.2e} vs scale {scale:.2f}"
    diff = np.abs(img.astype(np.int32) - j_img.astype(np.int32))
    assert diff.max() <= 1, f"uint8 image differs by {diff.max()} LSB"


def test_edit_changes_only_the_box(pipes):
    _, tpipe = pipes
    image = np.random.RandomState(4).randint(0, 256, (96, 128, 3), np.uint8)
    box = (40, 30, 90, 44)
    out, mask = tpipe.edit(image, box, "Hey", num_inference_steps=2, seed=1)
    assert out.dtype == np.uint8 and out.shape == image.shape
    assert mask.shape == image.shape[:2]
    inside = np.zeros(image.shape[:2], bool)
    inside[box[1]:box[3], box[0]:box[2]] = True
    np.testing.assert_array_equal(out[~inside], image[~inside])
    assert (out[inside] != image[inside]).any()
    again, _ = tpipe.edit(image, box, "Hey", num_inference_steps=2, seed=1)
    np.testing.assert_array_equal(again, out)  # seeded: deterministic


@pytest.mark.parametrize("field,value", [("sampler", "ddpm"),
                                         ("guidance_scale", 3.0),
                                         ("masked_latent_blend", True),
                                         ("encoder_reuse_interval", 2)])
def test_edit_options_run(pipes, field, value):
    # every EditConfig the JAX edit() takes runs through edit(): only the
    # box changes, the seed decides the result, and the option is not ignored
    _, tpipe = pipes
    ec = dataclasses.replace(tpipe.config.edit, **{field: value})
    image = np.random.RandomState(6).randint(0, 256, (64, 64, 3), np.uint8)
    box = (10, 10, 30, 20)
    out, _ = tpipe.edit(image, box, "x", num_inference_steps=4, seed=2,
                        edit_config=ec)
    inside = np.zeros(image.shape[:2], bool)
    inside[box[1]:box[3], box[0]:box[2]] = True
    np.testing.assert_array_equal(out[~inside], image[~inside])
    assert (out[inside] != image[inside]).any()
    again, _ = tpipe.edit(image, box, "x", num_inference_steps=4, seed=2,
                          edit_config=ec)
    np.testing.assert_array_equal(again, out)
    default, _ = tpipe.edit(image, box, "x", num_inference_steps=4, seed=2)
    assert (out != default).any()


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffute_tpu_torch\n"
        "for m in pkgutil.walk_packages(diffute_tpu_torch.__path__,\n"
        "                               'diffute_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'diffute_tpu', 'cv2'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_cli_edits_a_png(tmp_path):
    from PIL import Image

    from diffute_tpu_torch.serve import cli

    src = np.random.RandomState(5).randint(0, 256, (96, 128, 3), np.uint8)
    Image.fromarray(src).save(tmp_path / "in.png")
    cli.main(["--image", str(tmp_path / "in.png"), "--box", "40,30,90,44",
              "--text", "Hey", "--steps", "2", "--tiny", "--device", "cpu",
              "--out", str(tmp_path / "out.png")])
    out = np.asarray(Image.open(tmp_path / "out.png"))
    assert out.shape == src.shape
    np.testing.assert_array_equal(out[:30], src[:30])  # above the box
    # the serving flags run too: sampler, guidance, blend, reuse and the
    # UNet's three opt-in kernels (their plain versions on the CPU)
    cli.main(["--image", str(tmp_path / "in.png"), "--box", "40,30,90,44",
              "--text", "Hey", "--steps", "3", "--tiny", "--device", "cpu",
              "--sampler", "dpmpp", "--guidance_scale", "2.5", "--blend",
              "--reuse", "2", "--fused-gn", "--fused-conv", "--int8",
              "--out", str(tmp_path / "out2.png")])
    out2 = np.asarray(Image.open(tmp_path / "out2.png"))
    np.testing.assert_array_equal(out2[:30], src[:30])
    assert (out2 != out).any()
    # a checkpoint directory that does not exist is an error, not a random
    # init (tests/test_torch_port_checkpoint.py edits from a real one)
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        cli.main(["--image", "x.png", "--box", "1,1,2,2", "--text", "x",
                  "--checkpoint", str(tmp_path / "missing"), "--device", "cpu"])
