"""PyTorch port, stage 1: ``VAETrainer`` against the JAX package's
``make_vae_train_step`` at tiny width, fp32, on the CPU.

Both sides get the same weights (through the bridge), the same uint8 batch
and the same posterior normal: the JAX step draws it with
``jax.random.normal(rng, mean.shape)``, reproduced here and handed to the
port as a tensor.  Then the trainer's own behaviour: gradient
checkpointing changes nothing, bf16 keeps fp32 masters, a save and restore
continues bit for bit, and ``run_vae``'s flags.  With
``VAEConfig.use_flash_attention`` set on both sides, at 64 x 64 so that the
tiny VAE's mid-block sees 1024 keys and takes the gate's flash route (the
JAX Pallas kernels in interpret mode): encode, decode and a step, with the
tiny VAE's 16-wide mid-block and with one 256 wide (``small_config``'s
head_dim, which the port's ``csrc/flash_wide.cu`` takes on the card); and
each again with both packages' ``PIPELINE_FWD`` switches on, where the port
takes its deferred-softmax plain version.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.models import AutoencoderKL as JVAE
from diffute_tpu.train.optim import build_optimizer as j_build_optimizer
from diffute_tpu.train.state import TrainState as JTrainState
from diffute_tpu.train.vae_train import make_vae_train_step
from diffute_tpu.utils.params import init_vae_params as j_init_vae

import diffute_tpu_torch.ops.attention as tattn
from diffute_tpu_torch.compat import vae_state_dict
from diffute_tpu_torch.config import tiny_test_config
from diffute_tpu_torch.models import AutoencoderKL
from diffute_tpu_torch.pipeline import DiffUTEPipeline
from diffute_tpu_torch.train import UNetTrainer, VAETrainer, run_vae
from diffute_tpu_torch.train import checkpoint as ckpt
from diffute_tpu_torch.utils import init_pipeline_params

# the modules (each package's ops exports a function of the module's name)
jfa = importlib.import_module("diffute_tpu.ops.flash_attention")
tfa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")

BATCH, RES, TOTAL_STEPS = 2, 32, 10
# the tiny VAE downsamples by 2: its mid-block sees (64 / 2)^2 = 1024 keys,
# the least the gate sends to the flash kernels
FLASH_RES = 64
# a VAE of the tiny topology whose mid-block is 256 wide: one head of 256,
# the width of small_config's mid-block
WIDE_CHANNELS = (32, 256)


def _configs(accum=1, remat=False, mixed_precision="no", flash=False,
             res=RES, channels=None):
    out = []
    for cfg in (j_tiny(), tiny_test_config()):
        opt = dataclasses.replace(cfg.train.optimizer, lr_scheduler="constant")
        vae = dataclasses.replace(cfg.vae, remat=remat,
                                  use_flash_attention=flash)
        if channels:
            vae = dataclasses.replace(vae, block_out_channels=channels)
        out.append(dataclasses.replace(
            cfg, vae=vae,
            edit=dataclasses.replace(cfg.edit, resolution=res),
            train=dataclasses.replace(
                cfg.train, train_batch_size=BATCH,
                gradient_accumulation_steps=accum,
                mixed_precision=mixed_precision, optimizer=opt)))
    return out


def _batch(seed, lead=(BATCH,), res=RES):
    rng = np.random.RandomState(seed)
    return {"pixel_values": rng.randint(0, 256, lead + (res, res, 3)).astype(
        np.uint8)}


def _normal(jcfg, rng):
    """The JAX step's posterior normal for ``rng``, NCHW."""
    r = jcfg.edit.resolution // jcfg.vae.scale_factor
    z = jax.random.normal(rng, (BATCH, r, r, jcfg.vae.latent_channels),
                          jnp.float32)
    return torch.tensor(np.asarray(z).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def jparams():
    return j_init_vae(_configs()[0], jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def jparams_wide():
    return j_init_vae(_configs(channels=WIDE_CHANNELS)[0],
                      jax.random.PRNGKey(3))


def _trainer(tcfg, jparams):
    return VAETrainer(tcfg, vae_state_dict(jparams), device="cpu",
                      total_steps=TOTAL_STEPS)


def test_vae_step_matches_jax(jparams):
    """Loss, pre-clip grad norm, gradients and the updated weights."""
    _check_step_matches_jax(jparams, flash=False)


def test_vae_flash_step_matches_jax(jparams):
    """The same with both sides routing the mid-blocks through flash
    attention (its plain versions here, the Pallas kernels in interpret
    mode in JAX), at the same tolerances."""
    _check_step_matches_jax(jparams, flash=True)


def test_vae_flash_256_step_matches_jax(jparams_wide, monkeypatch):
    """The same with a 256-wide mid-block (head_dim 256), and the step
    reaches flash attention in both mid-blocks."""
    calls = _flash_spy(monkeypatch)
    _check_step_matches_jax(jparams_wide, flash=True,
                            channels=WIDE_CHANNELS)
    assert calls == [((BATCH, 1024, 1, 256), True)] * 2


def test_vae_flash_step_pipelined_matches_jax(jparams, monkeypatch):
    """test_vae_flash_step_matches_jax with both switches on: the port's
    mid-blocks take the deferred-softmax forward (16 kv tiles of 64 at
    head_dim 16), and the backward its LSE."""
    calls = _switch_pipelined_on(monkeypatch, 16)
    _check_step_matches_jax(jparams, flash=True, every_update=False)
    assert calls == [64] * 2


def test_vae_flash_256_step_pipelined_matches_jax(jparams_wide, monkeypatch):
    """The same at head_dim 256: 32 kv tiles of 32, the tile of
    csrc/flash_wide.cu's deferred kernel."""
    calls = _switch_pipelined_on(monkeypatch, 256)
    _check_step_matches_jax(jparams_wide, flash=True,
                            channels=WIDE_CHANNELS, every_update=False)
    assert calls == [tfa.WIDE_BLOCK_KV] * 2


def _switch_pipelined_on(monkeypatch, width):
    """Set PIPELINE_FWD in both packages; return the list into which the
    kv tile of each call the port makes of its deferred-softmax plain
    version is recorded.  JAX's own dispatcher takes its pipelined kernel
    only at two or more kv blocks; at the mid-block's 1024 keys it picks
    one 1024-wide block (``_pick_blocks``), so the JAX side computes what
    it computes with the switch off, and the results computed for the
    switch-off tests (the same function) are reused."""
    monkeypatch.setattr(jfa, "PIPELINE_FWD", True)
    monkeypatch.setattr(tfa, "PIPELINE_FWD", True)
    bq, bkv = jfa._resolve_blocks(1024, None, None)
    assert jfa._pick_blocks(1024, 1024, bq, bkv, jnp.float32)[1] == 1024
    assert tfa._pipelined_takes(1024, width)
    calls = []
    real = tfa.flash_fwd_pipelined_reference
    monkeypatch.setattr(tfa, "flash_fwd_pipelined_reference",
                        lambda *a: calls.append(a[-1]) or real(*a))
    return calls


# JAX's results by what was computed and for which VAE: the pipelined
# twins reuse those of the switch-off tests (see _switch_pipelined_on)
_JAX_RESULTS = {}


def _jax_step(jparams, jcfg, batch, rng, flash, channels):
    key = ("step", flash, channels)
    if key not in _JAX_RESULTS:
        # the step with plain SGD(1) reads the gradients back (grads =
        # params - new_params); AdamW then runs on them outside the step,
        # as optax's chain in the step would
        sgd = optax.sgd(1.0)
        sgd_state, j_metrics = jax.jit(make_vae_train_step(jcfg, sgd))(
            JTrainState.create(jparams, sgd), batch, rng)
        j_grad_tree = jax.tree_util.tree_map(lambda p, n: p - n, jparams,
                                             sgd_state.params)
        tx = j_build_optimizer(jcfg.train.optimizer, TOTAL_STEPS, BATCH)
        updates, _ = tx.update(j_grad_tree, tx.init(jparams), jparams)
        _JAX_RESULTS[key] = (
            j_metrics, vae_state_dict(j_grad_tree),
            vae_state_dict(optax.apply_updates(jparams, updates)))
    return _JAX_RESULTS[key]


def _check_step_matches_jax(jparams, flash, channels=None, every_update=True):
    """``every_update``: also bound the AdamW update of every weight, those
    whose gradient is near Adam's eps included, where the update divides
    by the gradient's size and so magnifies its rounding (the switch-off
    cases; the pipelined twins hold the gradients and the updates of the
    weights with a gradient far above eps, which is what the attention
    route moves)."""
    res = FLASH_RES if flash else RES
    jcfg, tcfg = _configs(flash=flash, res=res, channels=channels)
    batch, rng = _batch(0, res=res), jax.random.PRNGKey(4)
    j_metrics, j_grads, new = _jax_step(jparams, jcfg, batch, rng, flash,
                                        channels)

    trainer = _trainer(tcfg, jparams)
    loss = trainer.accumulate_grads(batch, _normal(jcfg, rng))
    grads = {k: v.grad.clone() for k, v in trainer.state.params_dict().items()}
    grad_norm = trainer.apply_grads()
    # fp32 on both sides, different op order
    np.testing.assert_allclose(float(loss), float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(grad_norm), float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    # the tolerance of the stage-2 step's gradient check
    assert set(grads) == set(j_grads)
    for key in sorted(grads):
        np.testing.assert_allclose(grads[key].numpy(), j_grads[key].numpy(),
                                   atol=2e-6, rtol=1e-3, err_msg=key)
    # one AdamW step moves each weight by about lr = 1e-4; where the
    # gradient is far above Adam's eps both sides agree to float precision
    mine = trainer.state.params_dict()
    errs = torch.cat([(mine[k].detach() - new[k]).abs().flatten()
                      for k in sorted(new)])
    big = torch.cat([j_grads[k].abs().flatten() for k in sorted(new)]) > 1e-4
    assert float(errs[big].max()) <= 1e-7
    if every_update:
        assert float(errs.max()) <= 2e-5
    assert trainer.state.step == 1


def test_vae_accumulation_matches_jax(jparams):
    jcfg, tcfg = _configs(accum=2)
    tx = j_build_optimizer(jcfg.train.optimizer, TOTAL_STEPS, BATCH)
    batch, rng = _batch(1, lead=(2, BATCH)), jax.random.PRNGKey(9)
    _, j_metrics = jax.jit(make_vae_train_step(jcfg, tx))(
        JTrainState.create(jparams, tx), batch, rng)
    metrics = _trainer(tcfg, jparams).step(
        batch, [_normal(jcfg, k) for k in jax.random.split(rng, 2)])
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(j_metrics["grad_norm"]), rtol=1e-4)


def test_vae_remat_changes_neither_loss_nor_grads(jparams):
    batch, noise = _batch(2), _normal(_configs()[0], jax.random.PRNGKey(1))
    out = []
    for remat in (False, True):
        trainer = _trainer(_configs(remat=remat)[1], jparams)
        loss = trainer.accumulate_grads(batch, noise)
        out.append((loss, [p.grad.clone() for p in trainer.state.params]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_vae_bf16_keeps_fp32_masters(jparams):
    trainer = _trainer(_configs(mixed_precision="bf16")[1], jparams)
    assert trainer.vae.encoder.conv_in.weight.dtype == torch.bfloat16
    assert trainer.draw(BATCH).shape == (BATCH, 4, RES // 2, RES // 2)
    metrics = trainer.step(_batch(3))
    assert np.isfinite(float(metrics["loss"]))
    master = trainer.state.params_dict()["encoder.conv_in.weight"]
    assert master.dtype == torch.float32
    assert torch.equal(trainer.vae.encoder.conv_in.weight, master.bfloat16())


def test_vae_save_restore_continues_bit_for_bit(tmp_path, jparams):
    tcfg = _configs(mixed_precision="bf16")[1]
    batches = [_batch(10 + i) for i in range(3)]
    straight = _trainer(tcfg, jparams)
    for b in batches:
        straight.step(b)
    first = _trainer(tcfg, jparams)
    for b in batches[:2]:
        first.step(b)
    path = ckpt.save_checkpoint(str(tmp_path), first.state.step,
                                first.state_dict())
    second = _trainer(tcfg, jparams)
    second.load_state_dict(ckpt.restore_checkpoint(path))
    second.step(batches[2])
    a, b = straight.state_dict(), second.state_dict()
    assert a["step"] == b["step"] == 3
    assert a["opt"]["count"] == b["opt"]["count"] == 3
    assert torch.equal(a["generator"], b["generator"])
    for part in ("params", "opt"):
        for name in ("mu", "nu") if part == "opt" else (None,):
            x = a[part][name] if name else a[part]
            y = b[part][name] if name else b[part]
            assert all(torch.equal(x[k], y[k]) for k in x), (part, name)


def test_run_vae_smoke_resumes_and_refuses_unported(tmp_path, capsys):
    out = str(tmp_path / "vae")
    common = ["--smoke", "--device", "cpu", "--output_dir", out,
              "--dataloader_num_workers", "1", "--report_to", "none"]
    history = run_vae.main(common)
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in history)
    history = run_vae.main([*common, "--resume_from_checkpoint", "latest",
                            "--max_train_steps", "3",
                            "--gradient_checkpointing"])
    assert [h["step"] for h in history] == [3]
    assert "resumed from" in capsys.readouterr().out
    for flags, what in ((["--steps_per_call", "2"], "steps_per_call"),
                        (["--optimizer", "adafactor"], "adafactor"),
                        (["--optimizer", "adamw8bit"], "adamw8bit")):
        with pytest.raises(NotImplementedError, match=f"not yet ported.*{what}"):
            run_vae.main([*common, *flags])
    assert run_vae.parse_args([]).device == "cuda"
    assert run_vae.parse_args([]).checkpointing_steps == 500
    assert run_vae.parse_args([]).report_to == "tensorboard"


def _flash_spy(monkeypatch):
    """Record the (q shape, grad enabled) of every call the attention gate
    makes to flash_attention."""
    calls = []
    real = tattn.flash_attention

    def spy(q, k, v, scale=None):
        calls.append((tuple(q.shape), torch.is_grad_enabled()))
        return real(q, k, v, scale=scale)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    return calls


def test_vae_flash_encode_decode_matches_jax(jparams, monkeypatch):
    _check_encode_decode_matches_jax(jparams, monkeypatch, width=16)


def test_vae_flash_256_encode_decode_matches_jax(jparams_wide, monkeypatch):
    """A 256-wide mid-block: single-head attention at head_dim 256."""
    _check_encode_decode_matches_jax(jparams_wide, monkeypatch, width=256,
                                     channels=WIDE_CHANNELS)


def test_vae_flash_encode_decode_pipelined_matches_jax(jparams, monkeypatch):
    """test_vae_flash_encode_decode_matches_jax with both switches on."""
    calls = _switch_pipelined_on(monkeypatch, 16)
    _check_encode_decode_matches_jax(jparams, monkeypatch, width=16)
    assert calls == [64] * 2


def test_vae_flash_256_encode_decode_pipelined_matches_jax(jparams_wide,
                                                           monkeypatch):
    """The 256-wide mid-block with both switches on."""
    calls = _switch_pipelined_on(monkeypatch, 256)
    _check_encode_decode_matches_jax(jparams_wide, monkeypatch, width=256,
                                     channels=WIDE_CHANNELS)
    assert calls == [tfa.WIDE_BLOCK_KV] * 2


def _check_encode_decode_matches_jax(jparams, monkeypatch, width,
                                     channels=None):
    jcfg, tcfg = _configs(flash=True, res=FLASH_RES, channels=channels)
    x = np.random.RandomState(7).uniform(
        -1, 1, (BATCH, FLASH_RES, FLASH_RES, 3)).astype(np.float32)
    key = ("encode_decode", channels)
    if key not in _JAX_RESULTS:
        jvae = JVAE(jcfg.vae)
        j_mean, j_logvar = jvae.apply({"params": jparams}, jnp.asarray(x),
                                      method=JVAE.encode)
        j_dec = jvae.apply({"params": jparams}, j_mean, method=JVAE.decode)
        _JAX_RESULTS[key] = (j_mean, j_logvar, j_dec)
    j_mean, j_logvar, j_dec = _JAX_RESULTS[key]
    model = AutoencoderKL(tcfg.vae).eval()
    model.load_state_dict(vae_state_dict(jparams), strict=True)
    calls = _flash_spy(monkeypatch)
    with torch.no_grad():
        mean, logvar = model.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
        dec = model.decode(mean)
    # each mid-block once, single-head over 1024 tokens of its width
    assert calls == [((BATCH, 1024, 1, width), False)] * 2
    # the goldens' tolerance (tests/test_torch_port_models.py)
    for name, mine, ref in (("mean", mean, j_mean), ("logvar", logvar, j_logvar),
                            ("decode", dec, j_dec)):
        np.testing.assert_allclose(mine.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), atol=5e-5, rtol=1e-4,
                                   err_msg=name)


def test_vae_flash_step_reaches_flash_in_both_mid_blocks(jparams, monkeypatch):
    # a training step differentiates through both: the autograd function
    jcfg, tcfg = _configs(flash=True, res=FLASH_RES)
    calls = _flash_spy(monkeypatch)
    loss = _trainer(tcfg, jparams).accumulate_grads(
        _batch(4, res=FLASH_RES), _normal(jcfg, jax.random.PRNGKey(5)))
    assert np.isfinite(float(loss))
    assert calls == [((BATCH, 1024, 1, 16), True)] * 2


def test_vae_flash_flag_reaches_the_model_from_every_entry_point(jparams):
    """The trainers replace the VAE config's dtype and keep the flag: stage
    1 (bf16), stage 2's frozen VAE and the serving pipeline."""
    cfg = _configs(mixed_precision="bf16", flash=True, res=FLASH_RES)[1]
    params = init_pipeline_params(cfg, seed=0, device="cpu")
    stage1 = _trainer(cfg, jparams)
    stage2 = UNetTrainer(cfg, params["unet"],
                         {"vae": params["vae"], "trocr": params["trocr"]},
                         device="cpu", total_steps=TOTAL_STEPS)
    pipe = DiffUTEPipeline(cfg, params, device="cpu")
    for vae in (stage1.vae, stage2.vae, pipe.vae):
        assert [vae.encoder.mid_block.attentions[0].use_flash,
                vae.decoder.mid_block.attentions[0].use_flash] == [True, True]
    assert stage1.config.vae.use_flash_attention
    assert stage1.vae.encoder.conv_in.weight.dtype == torch.bfloat16
    assert not any(m.use_flash for m in AutoencoderKL(
        _configs()[1].vae).modules() if hasattr(m, "use_flash"))
