"""PyTorch port, the parts of the training slice against the JAX package:
every function of ``schedules.py``, the optimizer over the six LR schedules
with clipping, the EMA, the synthetic dataset and ``train_crop``, the
``run_unet`` CLI, and the port's device and import rules.
"""

import dataclasses
import inspect
import json
import os
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffute_tpu.config import OptimizerConfig as JOptimizerConfig
from diffute_tpu.config import SchedulerConfig as JSchedulerConfig
from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.diffusion import schedules as jsched
from diffute_tpu.io import dataset as jdata
from diffute_tpu.models.ema import ema_init, ema_update
from diffute_tpu.pipeline import crop as jcrop
from diffute_tpu.train.optim import build_optimizer as j_build_optimizer
from diffute_tpu.utils.images import device_to_unit_range as j_unit_range

from diffute_tpu_torch.config import (
    OptimizerConfig,
    SchedulerConfig,
    tiny_test_config,
)
from diffute_tpu_torch.diffusion import schedules as tsched
from diffute_tpu_torch.io import dataset as tdata
from diffute_tpu_torch.models.ema import EmaState
from diffute_tpu_torch.pipeline import DiffUTEPipeline
from diffute_tpu_torch.pipeline import crop as tcrop
from diffute_tpu_torch.train import (UNetTrainer, build_optimizer, run_unet,
                                     run_vae)
from diffute_tpu_torch.utils import init_pipeline_params
from diffute_tpu_torch.utils.images import device_to_unit_range
from port_threads import torch_threads_per_worker  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
BETAS = ["linear", "scaled_linear", "squaredcos_cap_v2"]


# ---------------------------------------------------------------- schedules

def _schedules(beta_schedule, prediction_type="epsilon", **kw):
    return (jsched.make_schedule(JSchedulerConfig(
                beta_schedule=beta_schedule, prediction_type=prediction_type, **kw)),
            tsched.make_schedule(SchedulerConfig(
                beta_schedule=beta_schedule, prediction_type=prediction_type, **kw)))


def _nchw(a):
    return torch.tensor(np.asarray(a).transpose(0, 3, 1, 2))


def _close(mine, ref):
    """Steps: fp32 on both sides, the same formulas; rtol 1e-6 with an atol
    of 1e-6 of the result's scale for entries that cancel to near zero."""
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("beta_schedule", BETAS)
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_training_targets_match_jax(beta_schedule, prediction_type):
    js, ts = _schedules(beta_schedule, prediction_type)
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(),
                                  np.asarray(js.alphas_cumprod))  # bit for bit
    rng = np.random.RandomState(0)
    x0, noise = (rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
                 for _ in range(2))
    t = np.array([0, 437, 999])
    tt = torch.from_numpy(t)
    for name in ("add_noise", "get_velocity", "training_target"):
        ref = getattr(jsched, name)(js, jnp.asarray(x0), jnp.asarray(noise),
                                    jnp.asarray(t))
        _close(getattr(tsched, name)(ts, _nchw(x0), _nchw(noise), tt), ref)
    assert tsched.init_noise_sigma(ts) == jsched.init_noise_sigma(js) == 1.0
    x = _nchw(x0)
    assert tsched.scale_model_input(x, 5) is x


@pytest.mark.parametrize("beta_schedule", BETAS)
@pytest.mark.parametrize("variance_type", ["fixed_small", "fixed_large"])
def test_ddpm_step_matches_jax(beta_schedule, variance_type):
    js, ts = _schedules(beta_schedule, variance_type=variance_type)
    for n in (50, 150, 1000):
        np.testing.assert_array_equal(tsched.ddpm_timesteps(ts, n),
                                      jsched.ddpm_timesteps(js, n))
    with pytest.raises(ValueError):
        tsched.ddpm_timesteps(ts, 1001)
    rng = np.random.RandomState(1)
    out, sample, noise = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
                          for _ in range(3))
    steps = 50
    for t in (980, 500, 20, 0):  # t = 0: the previous timestep is < 0, no noise
        ref = jsched.ddpm_step(js, jnp.asarray(out), jnp.asarray(t),
                               jnp.asarray(sample), jnp.asarray(noise), steps)
        _close(tsched.ddpm_step(ts, _nchw(out), t, _nchw(sample), _nchw(noise),
                                steps), ref)


@pytest.mark.parametrize("beta_schedule", BETAS)
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_dpmpp_2m_step_matches_jax(beta_schedule, prediction_type):
    js, ts = _schedules(beta_schedule, prediction_type)
    rng = np.random.RandomState(2)
    out, sample, prev_x0 = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
                            for _ in range(3))
    # first step (first order), a middle step (second order), the final step
    for t, prev_t, t_last in ((951, 901, -1), (501, 451, 551), (1, -1, 51)):
        rx, rx0 = jsched.dpmpp_2m_step(
            js, jnp.asarray(out), jnp.asarray(t), jnp.asarray(prev_t),
            jnp.asarray(t_last), jnp.asarray(sample), jnp.asarray(prev_x0))
        x, x0 = tsched.dpmpp_2m_step(ts, _nchw(out), t, prev_t, t_last,
                                     _nchw(sample), _nchw(prev_x0))
        _close(x, rx)
        _close(x0, rx0)


def test_device_to_unit_range_matches_jax():
    x = np.random.RandomState(3).randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(j_unit_range(jnp.asarray(x), jd).astype(jnp.float32))
        out = device_to_unit_range(torch.from_numpy(x), td)
        assert out.dtype == td
        np.testing.assert_array_equal(out.float().numpy(), ref)
    f = torch.rand(2, 3)
    assert torch.equal(device_to_unit_range(f, torch.float32), f)


# ---------------------------------------------------------- optimizer, EMA

LR_SCHEDULES = ["constant", "constant_with_warmup", "linear", "cosine",
                "cosine_with_restarts", "polynomial"]


@pytest.mark.parametrize("lr_scheduler", LR_SCHEDULES)
@pytest.mark.parametrize("low_memory_adam", [False, True])
def test_optimizer_matches_optax(lr_scheduler, low_memory_adam):
    """5 steps on a small random tree, gradients large enough to trigger the
    clip on some steps and not on others, scale_lr on.  fp32 on both sides:
    rtol 1e-6 (atol 1e-7 for entries near zero); with the bf16 first moment
    the two sides round the same fp32 value, so the bound is the same."""
    kw = dict(learning_rate=3e-3, lr_scheduler=lr_scheduler, lr_warmup_steps=2,
              lr_num_cycles=2, scale_lr=True, max_grad_norm=1.0,
              low_memory_adam=low_memory_adam)
    total, tbs = 6, 4
    rng = np.random.RandomState(4)
    shapes = {"a": (5, 7), "b": (11,), "c": (2, 3, 3, 3)}
    params0 = {k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (1.0, 0.01, 3.0, 0.02, 0.5)]

    tx = j_build_optimizer(JOptimizerConfig(**kw), total, tbs)
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    jstate = tx.init(jp)
    tp = [torch.tensor(params0[k]) for k in shapes]
    opt = build_optimizer(tp, OptimizerConfig(**kw), total, tbs)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tp, shapes):
            p.grad = torch.tensor(g[k])
        norm = opt.step()
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(
                {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        for p, k in zip(tp, shapes):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert opt.mu[0].dtype == (torch.bfloat16 if low_memory_adam
                               else torch.float32)


@pytest.mark.parametrize("lr_scheduler", LR_SCHEDULES)
@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 4)])
def test_lr_schedules_match_optax(lr_scheduler, warmup, total):
    from diffute_tpu.train.optim import build_lr_schedule as j_schedule
    from diffute_tpu_torch.train.optim import build_lr_schedule

    kw = dict(learning_rate=2e-4, lr_scheduler=lr_scheduler,
              lr_warmup_steps=warmup, lr_num_cycles=3)
    js = j_schedule(JOptimizerConfig(**kw), total)
    ts = build_lr_schedule(OptimizerConfig(**kw), total)
    for step in range(total + 3):
        # the JAX side computes in fp32, the port in Python floats
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=2e-6,
                                   atol=1e-11, err_msg=f"step {step}")


@pytest.mark.parametrize("name", ["adafactor", "adamw8bit"])
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match=f"not yet ported.*{name}"):
        build_optimizer([torch.zeros(2)], OptimizerConfig(name=name), 10)
    with pytest.raises(ValueError):
        build_optimizer([torch.zeros(2)], OptimizerConfig(name="sgd"), 10)


def test_ema_matches_jax():
    rng = np.random.RandomState(5)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (6,))]
    jstate = ema_init([jnp.asarray(p) for p in p0])
    ema = EmaState([torch.tensor(p) for p in p0])
    for _ in range(3):
        new = [rng.standard_normal(p.shape).astype(np.float32) for p in p0]
        jstate = ema_update(jstate, [jnp.asarray(p) for p in new], 0.9999)
        ema.update([torch.tensor(p) for p in new], 0.9999)
        assert ema.step == int(jstate.step)
        for mine, ref in zip(ema.params, jstate.params):
            # fp32, the decay computed in fp32 there and in Python here
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6,
                                       atol=1e-7)


# ------------------------------------------------------------ dataset, crop

@pytest.mark.parametrize("vocab", ["fixed", "mixed", "random"])
def test_synthetic_dataset_bitexact(vocab):
    jcfg, tcfg = j_tiny(), tiny_test_config()
    jds = jdata.SyntheticSceneDataset(jcfg, seed=0, vocab=vocab)
    tds = tdata.SyntheticSceneDataset(tcfg, seed=0, vocab=vocab)
    assert len(tds) == len(jds)
    idx = [0, 1, 7, 12345, (1 << 30) - 1]
    mine, ref = [tds[i] for i in idx], [jds[i] for i in idx]
    for a, b in zip(mine, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == np.uint8
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tb, jb = tdata.make_unet_batch(mine, tcfg), jdata.make_unet_batch(ref, jcfg)
    assert tb.keys() == jb.keys()
    for k in tb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    with pytest.raises(ValueError):
        tdata.SyntheticSceneDataset(tcfg, vocab="latin")


def test_synthetic_dataset_full_resolution_bitexact():
    """The trainer's real geometry: 512^2 crops, 384^2 glyphs."""
    from diffute_tpu.config import DiffUTEConfig as JConfig
    from diffute_tpu_torch.config import DiffUTEConfig

    a = tdata.SyntheticSceneDataset(DiffUTEConfig(), vocab="mixed")[3]
    b = jdata.SyntheticSceneDataset(JConfig(), vocab="mixed")[3]
    assert a["pixel_values"].shape == (512, 512, 3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("hw,box,text", [
    ((300, 400), (50, 60, 180, 90), "hello"),         # box fits the window
    ((300, 900), (10, 100, 700, 140), "a long line"),  # wider: text truncated
    ((120, 200), (20, 30, 90, 50), "small"),           # short side < 256: upscaled
    ((90, 90), (5, 5, 60, 80), "tiny"),                # upscaled by 5
])
def test_train_crop_bitexact(hw, box, text):
    rng = np.random.RandomState(6)
    image = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    mask = np.zeros(hw, np.uint8)
    mask[box[1]:box[3] + 1, box[0]:box[2] + 1] = 1
    masked = image * (mask < 0.5)[..., None]
    a = tcrop.train_crop(image, mask, masked, np.int32(box), text,
                         np.random.default_rng(9))
    b = jcrop.train_crop(image, mask, masked, np.int32(box), text,
                         np.random.default_rng(9))
    assert (a.x_s, a.y_s, a.crop_scale, a.text) == (b.x_s, b.y_s, b.crop_scale,
                                                    b.text)
    for name in ("image", "mask", "masked_image"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def test_prefetch_loader_batches_match_jax():
    jcfg, tcfg = j_tiny(), tiny_test_config()
    assert tdata.PrefetchLoader.resolve_shuffle(1 << 30, 4) == "replacement"
    assert tdata.PrefetchLoader.resolve_shuffle(100, 4) == "epoch"

    def first(mod, cfg):
        loader = mod.PrefetchLoader(
            mod.SyntheticSceneDataset(cfg), 3,
            lambda ex: mod.make_unet_batch(ex, cfg), num_threads=1, seed=2)
        return next(iter(loader))

    a, b = first(tdata, tcfg), first(jdata, jcfg)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------- the CLI

def test_run_unet_smoke_on_cpu(capsys, tmp_path):
    history = run_unet.main(["--smoke", "--device", "cpu", "--output_dir",
                             str(tmp_path), "--report_to", "none"])
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               and h["grad_norm"] > 0 for h in history)
    out = capsys.readouterr().out
    assert "step 2: loss" in out and "done at step 2; final loss" in out


def test_run_unet_options_on_cpu(tmp_path):
    history = run_unet.main([
        "--smoke", "--device", "cpu", "--output_dir", str(tmp_path),
        "--report_to", "none", "--mixed_precision", "bf16",
        "--gradient_checkpointing", "--gradient_accumulation_steps", "2",
        "--use_ema", "--use_8bit_adam", "--scale_lr", "--lr_scheduler", "cosine",
        "--lr_warmup_steps", "1", "--noise_offset", "0.1",
        "--prediction_type", "v_prediction", "--synthetic_vocab", "mixed"])
    assert len(history) == 2 and np.isfinite(history[-1]["loss"])


@pytest.mark.parametrize("flags,item", [
    (["--optimizer", "adafactor"], "adafactor"),
    (["--optimizer", "adamw8bit"], "adamw8bit"),
    (["--steps_per_call", "2"], "steps_per_call"),
])
def test_run_unet_unported_flags_raise(flags, item, tmp_path):
    with pytest.raises(NotImplementedError,
                       match=f"not yet ported.*ROADMAP.*{re.escape(item)}"):
        run_unet.main(["--smoke", "--device", "cpu", "--output_dir",
                       str(tmp_path), "--report_to", "none", *flags])


def _manifest(root):
    from PIL import Image

    img = np.full((300, 400, 3), 220, np.uint8)
    img[60:90, 50:180] = 20
    Image.fromarray(img).save(root / "page.png")
    with open(root / "page.json", "w") as f:
        json.dump({"document": [{"text": "hello", "score": 0.9, "box": [
            [50, 60], [180, 60], [180, 90], [50, 90]]}]}, f)
    with open(root / "docs.csv", "w") as f:
        f.write(f"image_path,ocr_path\n{root / 'page.png'},{root / 'page.json'}\n")
    return str(root / "docs.csv")


@pytest.mark.parametrize("flag", ["--manifest", "--pretrained",
                                  "--resume_from_checkpoint", "--report_to"])
def test_run_unet_ported_flags_work(flag, tmp_path, monkeypatch, capsys):
    out = tmp_path / "out"
    common = ["--smoke", "--device", "cpu", "--output_dir", str(out),
              "--dataloader_num_workers", "1", "--report_to", "none"]
    if flag == "--manifest":
        extra = [flag, _manifest(tmp_path)]
    elif flag == "--pretrained":
        run_vae.main(["--smoke", "--device", "cpu", "--output_dir",
                      str(tmp_path / "vae"), "--report_to", "none"])
        extra = [flag, str(tmp_path / "vae" / "checkpoint-2")]
    elif flag == "--resume_from_checkpoint":
        run_unet.main(common)
        extra = [flag, "latest", "--max_train_steps", "3"]
    else:
        # tensorboardX, as torch.utils.tensorboard imports TensorFlow where
        # it is installed (slow)
        pytest.importorskip("tensorboardX")
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        extra = [flag, "tensorboard"]
    capsys.readouterr()
    history = run_unet.main([*common, *extra])
    assert history and all(np.isfinite(h["loss"]) for h in history)
    text = capsys.readouterr().out
    if flag == "--resume_from_checkpoint":
        assert [h["step"] for h in history] == [3]
        assert "resumed from" in text
    if flag == "--report_to":
        assert any(f.startswith("events.out.tfevents")
                   for f in os.listdir(out / "logs"))
    last = max(int(d.split("-")[1]) for d in os.listdir(out)
               if d.startswith("checkpoint-"))
    assert sorted(os.listdir(out / f"checkpoint-{last}")) == [
        "state", "trocr", "unet", "vae"]


# ------------------------------------------------- device and import rules

def test_entry_points_default_to_the_card(tmp_path):
    from diffute_tpu_torch.eval import OCRVerifier, acceptance
    from diffute_tpu_torch.eval import run as eval_run
    from diffute_tpu_torch.train import OCRTrainer, run_ocr

    for fn in (DiffUTEPipeline.__init__, UNetTrainer.__init__,
               init_pipeline_params, OCRTrainer.__init__,
               OCRVerifier.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert run_unet.parse_args([]).device == "cuda"
    assert run_unet.parse_args([]).report_to == "tensorboard"
    for parse in (run_ocr.parse_args, eval_run.parse_args):
        assert parse([]).device == "cuda"
    assert acceptance.parse_args(["--pretrained", "x"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable here")
    # without a card the defaults fail loudly instead of running on the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_pipeline_params(tiny_test_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffUTEPipeline(tiny_test_config(), {})
    with pytest.raises(SystemExit, match="no CUDA device"):
        run_unet.main(["--smoke"])
    from diffute_tpu_torch.serve import cli

    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--image", "x.png", "--box", "1,1,2,2", "--text", "x"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OCRTrainer(tiny_test_config(), None, {"encoder": {}, "decoder": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OCRVerifier(tiny_test_config().trocr, None, {}, {})
    with pytest.raises(SystemExit, match="no CUDA device"):
        run_ocr.main(["--smoke", "--output_dir", str(tmp_path / "ocr")])
    with pytest.raises(SystemExit, match="no CUDA device"):
        eval_run.main(["--tiny", "--synthetic", "1", "--steps", "1"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        acceptance.main(["--pretrained", str(tmp_path), "--model_scale",
                         "tiny"])


def test_port_sources_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|diffute_tpu)(\.|\s|$)", re.M)
    files = [REPO / "chip_smoke.py",
             *sorted((REPO / "diffute_tpu_torch").rglob("*.py"))]
    assert len(files) > 30
    bad = [str(f.relative_to(REPO)) for f in files
           if pattern.search(f.read_text())]
    assert not bad, bad
