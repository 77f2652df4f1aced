"""PyTorch port, the training slice as a whole: optimizer steps of the
stage-2 UNet trainer against the JAX package's train step, at tiny width.

Edit resolution 64 gives a 32x32 latent, so the UNet's top-level
self-attentions have 1024 tokens and take the flash route with its backward
on both sides (JAX: the Pallas kernels in interpret mode; the port on the
CPU: the kernels' plain versions).  Both sides get the same weights (through
the bridge), the same uint8 batch, and the JAX step's five draws, reproduced
with ``jax.random.split(rng, 5)`` and handed to the port as tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.train.optim import build_optimizer as j_build_optimizer
from diffute_tpu.train.state import TrainState as JTrainState
from diffute_tpu.train.unet_train import make_unet_train_step
from diffute_tpu.utils import init_pipeline_params as j_init

import diffute_tpu_torch.ops.attention as tattn
from diffute_tpu_torch.compat import pipeline_state_dicts, unet_state_dict
from diffute_tpu_torch.config import tiny_test_config
from diffute_tpu_torch.ops import flash_attention
from diffute_tpu_torch.train import TrainDraws, UNetTrainer

RES, BATCH, TOTAL_STEPS = 64, 2, 10


def _configs(mixed_precision="no", accum=1, remat=False, noise_offset=0.0,
             prediction_type="epsilon"):
    out = []
    for cfg in (j_tiny(), tiny_test_config()):
        opt = dataclasses.replace(cfg.train.optimizer, lr_scheduler="constant")
        out.append(dataclasses.replace(
            cfg,
            unet=dataclasses.replace(cfg.unet, use_flash_attention=True,
                                     remat=remat),
            edit=dataclasses.replace(cfg.edit, resolution=RES),
            scheduler=dataclasses.replace(cfg.scheduler,
                                          prediction_type=prediction_type),
            train=dataclasses.replace(
                cfg.train, train_batch_size=BATCH, mixed_precision=mixed_precision,
                gradient_accumulation_steps=accum, noise_offset=noise_offset,
                optimizer=opt)))
    return out


def _batch(seed, cfg, lead=(BATCH,)):
    rng = np.random.RandomState(seed)
    g = cfg.trocr.image_size
    masks = np.zeros(lead + (RES, RES), np.uint8)
    masks[..., 16:40, 8:56] = 1
    pixels = rng.randint(0, 256, lead + (RES, RES, 3)).astype(np.uint8)
    return {"pixel_values": pixels, "masks": masks,
            "masked_images": pixels * (1 - masks)[..., None],
            "glyph_pixels": rng.randint(0, 256, lead + (g, g, 3)).astype(np.uint8)}


def _draws(jcfg, rng, dtype=jnp.float32):
    """The JAX loss_fn's draws for ``rng``, as the port's NCHW tensors."""
    kv, km, kn, kt, ko = jax.random.split(rng, 5)
    r = RES // jcfg.vae.scale_factor
    shape = (BATCH, r, r, jcfg.vae.latent_channels)

    def nchw(a):
        t = torch.tensor(np.asarray(a.astype(jnp.float32)).transpose(0, 3, 1, 2))
        return t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)

    return TrainDraws(
        vae_noise=nchw(jax.random.normal(kv, shape, dtype)),
        masked_noise=nchw(jax.random.normal(km, shape, dtype)),
        noise=nchw(jax.random.normal(kn, shape, dtype)),
        timesteps=torch.tensor(np.asarray(jax.random.randint(
            kt, (BATCH,), 0, jcfg.scheduler.num_train_timesteps))).long(),
        offset_noise=nchw(jax.random.normal(ko, (BATCH, 1, 1, shape[-1]), dtype)))


def _frozen(jparams):
    return {"vae": jparams["vae"], "trocr": jparams["trocr"]}


def _port_trainer(tcfg, jparams):
    sd = pipeline_state_dicts(jparams)
    return UNetTrainer(tcfg, sd["unet"], {"vae": sd["vae"], "trocr": sd["trocr"]},
                       device="cpu", total_steps=TOTAL_STEPS)


def _param_errs(trainer, j_unet_params):
    """|port - JAX| of every master weight, flattened in key order."""
    ref = unet_state_dict(j_unet_params)
    mine = trainer.state.state_dict()
    assert set(ref) == set(mine)
    return torch.cat([(mine[k].detach() - ref[k]).abs().flatten()
                      for k in sorted(ref)])


def _assert_params_close(errs):
    # Adam moves a weight by lr * g / (|g| + eps): where |g| is near
    # eps = 1e-8 the last bits of g decide the direction, so a handful of
    # weights differ by a fraction of lr = 1e-4.  Measured: max 5.2e-6, and
    # 4 of 201,364 weights above 1e-6, after either step.
    assert float(errs.max()) <= 2e-5
    assert float((errs > 1e-6).float().mean()) <= 1e-4


@pytest.fixture(scope="module")
def jparams():
    return j_init(_configs()[0], seed=3)


def test_two_train_steps_match_jax(jparams, monkeypatch):
    """One AdamW step, then a second one with gradient accumulation 2, fp32:
    loss, pre-clip grad norm, gradients and every updated parameter."""
    jcfg, tcfg = _configs(noise_offset=0.1)
    tx = j_build_optimizer(jcfg.train.optimizer, TOTAL_STEPS, BATCH)
    state = JTrainState.create(jparams["unet"], tx)
    batch, rng = _batch(0, jcfg), jax.random.PRNGKey(5)
    j_step = jax.jit(make_unet_train_step(jcfg, tx))
    state1, j_metrics = j_step(state, _frozen(jparams), batch, rng)
    # the same step with plain SGD(1) as the optimizer reads the gradients
    # back: grads = params - new_params
    sgd = optax.sgd(1.0)
    sgd_state, _ = jax.jit(make_unet_train_step(jcfg, sgd))(
        JTrainState.create(jparams["unet"], sgd), _frozen(jparams), batch, rng)
    j_grads = unet_state_dict(jax.tree_util.tree_map(
        lambda p, n: p - n, jparams["unet"], sgd_state.params))

    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash_attention(*a, **kw))
    trainer = _port_trainer(tcfg, jparams)
    loss = trainer.accumulate_grads(batch, _draws(jcfg, rng))
    assert len(calls) == 3  # the 1024-token self-attentions took the flash route
    grads = {k: v.grad.clone() for k, v in trainer.state.state_dict().items()}
    grad_norm = trainer.apply_grads()

    # fp32 on both sides, different op order: the loss agreed to 8e-7
    # relative and the grad norm to 5e-7 when this was written
    np.testing.assert_allclose(float(loss), float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(grad_norm), float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    # gradients, read back through a parameter difference (exact to the
    # parameters' ulp, ~1e-8): the largest difference measured over all
    # weights was 3e-7, of gradients up to 0.27 (global norm 2.2)
    for key in ("conv_in.weight", "conv_out.bias", "mid_block.resnets.0.conv1.weight",
                "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
                "up_blocks.1.attentions.1.transformer_blocks.0.attn1.to_v.weight",
                "up_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k.weight"):
        np.testing.assert_allclose(grads[key].numpy(), j_grads[key].numpy(),
                                   atol=2e-6, rtol=1e-3, err_msg=key)
    # one AdamW step moves every weight by about lr = 1e-4; where the
    # gradient is well above Adam's eps the two sides agree to 1e-7
    # (measured 3e-8 on the 174,344 weights with |g| > 1e-4)
    errs = _param_errs(trainer, state1.params)
    big = torch.cat([j_grads[k].abs().flatten() for k in sorted(j_grads)]) > 1e-4
    assert float(errs[big].max()) <= 1e-7
    _assert_params_close(errs)

    # second step, gradient accumulation 2, continuing both states
    jcfg2, tcfg2 = _configs(noise_offset=0.1, accum=2)
    batch2, rng2 = _batch(1, jcfg, lead=(2, BATCH)), jax.random.PRNGKey(6)
    state2, j_metrics2 = jax.jit(make_unet_train_step(jcfg2, tx))(
        state1, _frozen(jparams), batch2, rng2)
    trainer.config = tcfg2
    metrics2 = trainer.step(batch2, [_draws(jcfg, k)
                                     for k in jax.random.split(rng2, 2)])
    np.testing.assert_allclose(float(metrics2["loss"]),
                               float(j_metrics2["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics2["grad_norm"]),
                               float(j_metrics2["grad_norm"]), rtol=1e-4)
    assert trainer.state.step == int(state2.step) == 2
    _assert_params_close(_param_errs(trainer, state2.params))
