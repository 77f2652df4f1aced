"""PyTorch port, the fp32 flash slice as a whole on the CPU: an fp32 edit
and an fp32 stage-2 step with both ``UNetConfig.use_flash_attention`` and
``VAEConfig.use_flash_attention`` set, against the JAX package's fp32 edit
and ``make_unet_train_step`` at ``mixed_precision="no"`` with both set; and
``run_unet``'s rule that turns flash on on the card at both precisions.

Edit resolution 64 gives a 32x32 latent: the UNet's top-level
self-attentions and the tiny VAE's mid-blocks have 1024 tokens and take the
flash route on both sides (JAX: the Pallas kernels in interpret mode; the
port on the CPU: the kernels' plain versions, which on the card are held to
``csrc/flash_fp32.cu``).  Both sides get the same weights (through the
bridge) and the JAX draws.
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
from diffute_tpu.train.optim import build_optimizer as j_build_optimizer
from diffute_tpu.train.state import TrainState as JTrainState
from diffute_tpu.train.unet_train import make_unet_train_step
from diffute_tpu.utils import init_pipeline_params as j_init

import diffute_tpu_torch.ops.attention as tattn
import diffute_tpu_torch.utils as tutils
from diffute_tpu_torch.compat import pipeline_state_dicts
from diffute_tpu_torch.config import tiny_test_config
from diffute_tpu_torch.ops import flash_attention
from diffute_tpu_torch.pipeline import DiffUTEPipeline
from diffute_tpu_torch.train import run_unet

# pytest puts tests/ itself on sys.path (conftest.py, prepend import mode)
from test_composed_parity import _pipeline_noise
from test_torch_port_train import _batch, _draws, _frozen, _port_trainer

RES, STEPS, SEED = 64, 6, 0
# the tiny models' head_dims: the UNet's top level (16 channels, 2 heads)
# and the VAE's mid-block (16 channels, one head)
UNET_HEAD_DIM, VAE_HEAD_DIM = 8, 16


def _fp32_flash(cfg, **train):
    """``cfg`` in fp32 with both flash flags set, at RES."""
    assert cfg.unet.dtype == cfg.vae.dtype == jnp.float32 or (
        cfg.unet.dtype == cfg.vae.dtype == torch.float32)
    opt = dataclasses.replace(cfg.train.optimizer, lr_scheduler="constant")
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, use_flash_attention=True),
        vae=dataclasses.replace(cfg.vae, use_flash_attention=True),
        edit=dataclasses.replace(cfg.edit, resolution=RES),
        train=dataclasses.replace(cfg.train, optimizer=opt, **train))


@pytest.fixture(scope="module")
def jparams():
    return j_init(_fp32_flash(j_tiny()), seed=3)


def _route_spy(monkeypatch):
    """The head_dim of every call the models make of the flash route."""
    calls = []
    monkeypatch.setattr(
        tattn, "flash_attention",
        lambda q, *a, **kw: calls.append(q.shape[-1]) or flash_attention(
            q, *a, **kw))
    return calls


def test_fp32_edit_with_both_flags_matches_jax(jparams, monkeypatch):
    jcfg = _fp32_flash(j_tiny())
    jpipe = JPipeline(jcfg, jparams)
    tpipe = DiffUTEPipeline(_fp32_flash(tiny_test_config()),
                            pipeline_state_dicts(jparams), device="cpu")
    rng = np.random.RandomState(11)
    image = rng.randint(0, 256, (RES, RES, 3), np.uint8)
    mask = generate_mask((RES, RES), np.int32([8, 12, 40, 30]))
    masked = make_masked_image(image, mask)
    glyph = trocr_preprocess_host([render_glyph("Hi", jcfg.glyph)], jcfg.trocr)

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
    r = RES // jcfg.vae.scale_factor
    n_init, n_mask, *_ = _pipeline_noise(jcfg, SEED, STEPS, "ddim",
                                         (1, r, r, 4))
    calls = _route_spy(monkeypatch)

    def nchw(a):
        return torch.tensor(np.asarray(a).transpose(0, 3, 1, 2))

    with torch.inference_mode():
        prepped = tpipe._device_prep(
            torch.from_numpy(mask[None]), torch.from_numpy(masked[None]),
            torch.from_numpy(glyph), nchw(n_init), nchw(n_mask))
        lat, traj = tpipe._device_loop(STEPS, *prepped, return_trajectory=True)
        img = tpipe._device_decode(lat)[0].numpy()

    # 3 UNet self-attentions a step, the encoder's mid-block (the masked
    # crop) and the decoder's took the flash route, in fp32
    assert sorted(calls) == ([UNET_HEAD_DIM] * 3 * STEPS
                             + [VAE_HEAD_DIM] * 2)
    # per-step latents within 5e-3 of the running scale, the image within 1
    # LSB: tests/test_torch_port_pipeline.py's bounds
    for i in range(STEPS):
        ref = j_traj[i].transpose(0, 3, 1, 2)
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(traj[i].numpy() - ref).max())
        assert err <= 5e-3 * scale, f"step {i}: {err:.2e} vs scale {scale:.2f}"
    diff = np.abs(img.astype(np.int32) - j_img.astype(np.int32))
    assert diff.max() <= 1, f"uint8 image differs by {diff.max()} LSB"


def test_fp32_stage2_step_with_both_flags_matches_jax(jparams, monkeypatch):
    jcfg = _fp32_flash(j_tiny(), train_batch_size=2, mixed_precision="no")
    tcfg = _fp32_flash(tiny_test_config(), train_batch_size=2,
                       mixed_precision="no")
    tx = j_build_optimizer(jcfg.train.optimizer, 10, 2)
    state = JTrainState.create(jparams["unet"], tx)
    batch, rng = _batch(0, jcfg), jax.random.PRNGKey(5)
    _, j_metrics = jax.jit(make_unet_train_step(jcfg, tx))(
        state, _frozen(jparams), batch, rng)

    calls = _route_spy(monkeypatch)
    trainer = _port_trainer(tcfg, jparams)
    metrics = trainer.step(batch, _draws(jcfg, rng))
    # the frozen encodes of the masked and the target image (the VAE's
    # mid-block), then the UNet's 3 self-attentions with their backward
    assert sorted(calls) == [UNET_HEAD_DIM] * 3 + [VAE_HEAD_DIM] * 2
    # fp32 on both sides: tests/test_torch_port_train.py's bounds
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(j_metrics["grad_norm"]), rtol=1e-4)


class _Built(Exception):
    """Raised in place of the weights' initialisation, with the config
    run_unet built."""


@pytest.mark.parametrize("mixed_precision", ["no", "bf16"])
def test_run_unet_turns_flash_on_on_the_card_at_both_precisions(
        monkeypatch, mixed_precision):
    def init(config, **kw):
        raise _Built(config)

    monkeypatch.setattr(tutils, "init_pipeline_params", init)
    for device, expected in (("cuda", True), ("cpu", False)):
        monkeypatch.setattr(tutils, "resolve_device",
                            lambda d, _dev=device: torch.device(_dev))
        with pytest.raises(_Built) as built:
            run_unet.prepare(["--smoke", "--mixed_precision", mixed_precision,
                              "--report_to", "none", "--output_dir",
                              "unused"])
        config = built.value.args[0]
        assert config.unet.use_flash_attention is expected
        assert config.train.mixed_precision == mixed_precision
