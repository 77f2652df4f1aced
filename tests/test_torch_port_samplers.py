"""PyTorch port, the serving modes of ``edit()``: the staged tiny edit against
the JAX package's staged programs under every sampler, classifier-free
guidance with the masked-latent blend, encoder reuse and int8 weights.

Both sides get the same weights (through the bridge), the same scene and the
JAX key-tree noise draws (tests/test_composed_parity.py's ``_pipeline_noise``)
for the cases of its ``test_composed_denoise_parity``, plus reuse k = 2 and
k = 3 (with a remainder of full steps) and the int8 edit with all three UNet
flags on.  Bounds as in tests/test_torch_port_pipeline.py: every step's
latents within 5e-3 of the running scale, the final image within 1 LSB.
"""

import dataclasses
import functools

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

from diffute_tpu_torch.compat import pipeline_state_dicts
from diffute_tpu_torch.config import tiny_test_config
from diffute_tpu_torch.pipeline import DiffUTEPipeline

# pytest puts tests/ itself on sys.path (conftest.py, prepend import mode)
from test_composed_parity import _pipeline_noise
from port_threads import torch_threads_per_worker  # noqa: F401

SEED = 0
ALL_FLAGS = dict(use_fused_groupnorm=True, use_fused_conv=True,
                 use_int8_weights=True)


def _pipes(jparams, **unet_flags):
    jcfg, tcfg = j_tiny(), tiny_test_config()
    jcfg = dataclasses.replace(
        jcfg, unet=dataclasses.replace(jcfg.unet, **unet_flags))
    tcfg = dataclasses.replace(
        tcfg, unet=dataclasses.replace(tcfg.unet, **unet_flags))
    return (JPipeline(jcfg, jparams),
            DiffUTEPipeline(tcfg, pipeline_state_dicts(jparams), device="cpu"))


@pytest.fixture(scope="module")
def setup():
    jparams = j_init(j_tiny(), seed=3)
    cfg = j_tiny()
    res = cfg.edit.resolution
    rng = np.random.RandomState(11)
    image = rng.randint(0, 256, (res, res, 3), np.uint8)
    mask = generate_mask((res, res), np.int32([8, 12, 24, 20]))
    glyphs = {text: trocr_preprocess_host([render_glyph(text, cfg.glyph)],
                                          cfg.trocr) for text in ("Hi", "")}
    return dict(jparams=jparams, pipes=_pipes(jparams), image=image, mask=mask,
                masked=make_masked_image(image, mask), glyph=glyphs["Hi"],
                null_glyph=glyphs[""])


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, -3)))


def _compare(setup, pipes, sampler, steps, guidance, blend, k):
    jpipe, tpipe = pipes
    use_cfg = guidance > 1.0
    image, mask, masked = setup["image"], setup["mask"], setup["masked"]

    # JAX: the staged programs edit() chains, the loop emitting every step
    dummy = jnp.zeros((1, 1, 1, 3), jnp.uint8)
    crop_in = jnp.asarray(image[None]) if blend else dummy
    null_in = jnp.asarray(setup["null_glyph"]) if use_cfg else dummy
    inputs = (crop_in, jnp.asarray(mask[None]), jnp.asarray(masked[None]),
              jnp.asarray(setup["glyph"]))
    sig = (steps, sampler, guidance, blend, k)
    jpipe._get_compiled(*sig)
    prep, _, _ = jpipe._stages[sig]
    *prepped, k_loop = prep(jpipe.params, *inputs, null_in, np.int32(SEED))
    loop = jax.jit(functools.partial(jpipe._device_loop, *sig,
                                     return_trajectory=True))
    j_lat, j_traj = loop(jpipe.params["unet"], *prepped, k_loop)
    j_img = np.asarray(jpipe._decode(jpipe.params["vae"], j_lat))[0]
    j_traj = np.asarray(j_traj)

    # port: the same stages, fed the JAX draws
    r = jpipe.config.edit.resolution // jpipe.config.vae.scale_factor
    n_init, n_mask, n_crop, blend_noise, step_noise = _pipeline_noise(
        jpipe.config, SEED, steps, sampler, (1, r, r, 4))
    with torch.inference_mode():
        prepped = tpipe._device_prep(
            torch.from_numpy(mask[None]), torch.from_numpy(masked[None]),
            torch.from_numpy(setup["glyph"]), _nchw(n_init), _nchw(n_mask),
            null_glyph_u8=(torch.from_numpy(setup["null_glyph"])
                           if use_cfg else None),
            crop_u8=torch.from_numpy(image[None]) if blend else None,
            crop_noise=_nchw(n_crop) if blend else None)
        lat, traj = tpipe._device_loop(
            steps, *prepped, sampler=sampler, guidance_scale=guidance,
            blend=blend, reuse_interval=k,
            step_noise=_nchw(step_noise) if sampler == "ddpm" else None,
            blend_noise=_nchw(blend_noise) if blend else None,
            return_trajectory=True)
        img = tpipe._device_decode(lat)[0].numpy()

    # per-step latents within 5e-3 of the running scale (fp32 on both sides,
    # different op order; early steps divide by sqrt(alpha_bar)), the final
    # image within 1 LSB: tests/test_composed_parity.py's bounds
    assert traj.shape[0] == steps == j_traj.shape[0]
    for i in range(steps):
        ref = j_traj[i].transpose(0, 3, 1, 2)
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(traj[i].numpy() - ref).max())
        assert err <= 5e-3 * scale, (
            f"{sampler} step {i}: {err:.2e} vs scale {scale:.2f}")
    diff = np.abs(img.astype(np.int32) - j_img.astype(np.int32))
    assert diff.max() <= 1, f"uint8 image differs by {diff.max()} LSB"


@pytest.mark.parametrize("sampler,steps,guidance,blend,k", [
    ("ddpm", 12, 1.0, False, 1),
    ("ddim", 10, 1.0, False, 1),
    ("ddim", 10, 3.0, True, 1),    # guidance as one batch-2B pass + blend
    ("dpmpp", 12, 1.0, False, 1),  # the (x0, t_last) carry
    ("dpmpp", 10, 3.0, True, 1),
    ("ddim", 10, 1.0, False, 2),   # encoder reuse, no remainder
    ("dpmpp", 11, 3.0, True, 3),   # reuse in threes, two full steps left over
])
def test_staged_edit_matches_jax(setup, sampler, steps, guidance, blend, k):
    _compare(setup, setup["pipes"], sampler, steps, guidance, blend, k)


def test_int8_flagged_edit_matches_jax(setup):
    # both sides quantise the same float weights at load (bit for bit the
    # same int8 leaves), so the float bounds hold
    pipes = _pipes(setup["jparams"], **ALL_FLAGS)
    assert pipes[1].unet.config.use_int8_weights
    _compare(setup, pipes, "dpmpp", 8, 3.0, True, 2)


def test_reuse_runs_the_encoder_every_kth_step(setup, monkeypatch):
    _, tpipe = setup["pipes"]
    calls = {"encode": 0, "decode": 0}
    for name in calls:
        fn = getattr(tpipe.unet, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tpipe.unet, name, counted)
    ec = dataclasses.replace(tpipe.config.edit, encoder_reuse_interval=3)
    tpipe.edit(setup["image"], (8, 12, 24, 20), "Hi", num_inference_steps=8,
               edit_config=ec)
    # 8 steps in threes: full passes at steps 0, 3 and the remainder 6, 7
    assert calls == {"encode": 4, "decode": 8}


def test_loop_rejects_missing_inputs(setup):
    _, tpipe = setup["pipes"]
    z = torch.zeros(1, 4, 4, 4)
    ctx = torch.zeros(1, 5, 16)
    with pytest.raises(ValueError, match="null context"):
        tpipe._device_loop(2, ctx, z[:, :1], z, z, guidance_scale=2.0)
    with pytest.raises(ValueError, match="blend"):
        tpipe._device_loop(2, ctx, z[:, :1], z, z, blend=True)
    with pytest.raises(ValueError, match="per-step noise"):
        tpipe._device_loop(2, ctx, z[:, :1], z, z, sampler="ddpm")
    with pytest.raises(ValueError, match="unknown sampler"):
        tpipe._device_loop(2, ctx, z[:, :1], z, z, sampler="euler")
