"""PyTorch port, checkpoints and diffusers-layout weights, against the JAX
package at tiny width on the CPU.

- A directory that the JAX package's ``export_diffusers_layout`` writes
  loads through the port's ``load_diffusers_layout`` (strict), and its edit
  equals the edit of the same weights taken through ``compat.from_jax``,
  bit for bit; ``resolve_diffusers_layout`` answers as JAX's does.
- The port's export of the same weights equals JAX's file for file, key
  for key, array for array, ``config.json`` included; legacy VAE names and
  VisionEncoderDecoder TrOCR checkpoints load in both to equal weights;
  the port's safetensors writer gives what safetensors' own does.
- ``UNetTrainer``: N steps, a save, a restore into a fresh trainer and M
  more steps equal N + M steps without a break, bit for bit; rotation,
  finalized-only ``latest``, a renamed directory and the early exit as in
  ``tests/test_cli_train.py``; ``run_unet``'s checkpoint flags and the
  serving entry points' ``--checkpoint``.
"""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from diffute_tpu.compat import import_trocr_state_dict as j_import_trocr
from diffute_tpu.compat import import_vae_state_dict as j_import_vae
from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.serve.loading import \
    resolve_diffusers_layout as j_resolve_layout
from diffute_tpu.train import checkpoint as jckpt
from diffute_tpu.utils import init_pipeline_params as j_init

from diffute_tpu_torch.compat import (pipeline_state_dicts, trocr_state_dict,
                                      vae_state_dict)
from diffute_tpu_torch.compat import diffusers as compat
from diffute_tpu_torch.config import (DiffUTEConfig, small_config,
                                      tiny_test_config)
from diffute_tpu_torch.io.dataset import SyntheticSceneDataset, make_unet_batch
from diffute_tpu_torch.pipeline import DiffUTEPipeline
from diffute_tpu_torch.serve import cli, web
from diffute_tpu_torch.serve.loading import (layout_scale,
                                             load_diffusers_layout,
                                             resolve_diffusers_layout)
from diffute_tpu_torch.train import UNetTrainer, run_unet, run_vae
from diffute_tpu_torch.train import checkpoint as ckpt
from diffute_tpu_torch.utils import init_pipeline_params

FILES = {"unet": "diffusion_pytorch_model.safetensors",
         "unet_ema": "diffusion_pytorch_model.safetensors",
         "vae": "diffusion_pytorch_model.safetensors",
         "trocr": "model.safetensors"}


@pytest.fixture(scope="module")
def jparams():
    return j_init(j_tiny(), seed=7)


def _j_export(path, jparams, subs=("unet", "vae", "trocr"), ema=None):
    cfg = j_tiny()
    jckpt.export_diffusers_layout(
        str(path),
        unet_params=jparams["unet"] if "unet" in subs else None,
        unet_ema_params=ema,
        vae_params=jparams["vae"] if "vae" in subs else None,
        trocr_params=jparams["trocr"] if "trocr" in subs else None,
        unet_config=jckpt.diffusers_unet_config_json(cfg.unet),
        vae_config=jckpt.diffusers_vae_config_json(cfg.vae),
        trocr_config=jckpt.vit_config_json(cfg.trocr))


def _safetensors(path):
    from safetensors.numpy import load_file

    return load_file(str(path))


def _assert_state_equal(a, b, path=""):
    """Two trainer state_dicts equal bit for bit (tensors and scalars)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_state_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


# ------------------------------------------------------ loading and export

def test_jax_export_loads_strict_and_edits_bit_for_bit(tmp_path, jparams):
    _j_export(tmp_path, jparams)
    cfg = tiny_test_config()
    loaded = load_diffusers_layout(str(tmp_path), cfg, device="cpu")
    bridged = pipeline_state_dicts(jparams)
    assert list(loaded) == ["vae", "unet", "trocr"]
    for name in loaded:
        assert set(loaded[name]) == set(bridged[name]), name
        for k, v in loaded[name].items():
            assert v.dtype == torch.float32 and torch.equal(v, bridged[name][k])
    image = np.random.RandomState(1).randint(0, 255, (48, 64, 3), np.uint8)
    box = (10, 12, 40, 26)
    outs = [DiffUTEPipeline(cfg, p, device="cpu").edit(
        image, box, "Hey", num_inference_steps=3, seed=5)[0]
        for p in (loaded, bridged)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert layout_scale(str(tmp_path)) == "tiny"


def test_resolve_layout_answers_as_jax(tmp_path, jparams):
    full, ema, part = (tmp_path / n for n in ("full", "ema", "part"))
    _j_export(full, jparams)
    _j_export(ema, jparams, subs=("unet", "vae"), ema=jparams["unet"])
    _j_export(part, jparams, subs=("vae",))
    (part / "unet").mkdir()  # a bare directory resolves to None
    for d in (full, ema, part, tmp_path / "missing"):
        assert resolve_diffusers_layout(str(d)) == j_resolve_layout(str(d))
    assert resolve_diffusers_layout(str(ema))["unet"].endswith(
        os.path.join("unet_ema", FILES["unet"]))
    assert resolve_diffusers_layout(str(part))["unet"] is None


def test_partial_layout_random_inits_only_what_is_missing(tmp_path, jparams):
    _j_export(tmp_path, jparams, subs=("vae",))
    cfg = tiny_test_config()
    loaded = load_diffusers_layout(str(tmp_path), cfg, device="cpu")
    vae = vae_state_dict(jparams["vae"])
    assert all(torch.equal(loaded["vae"][k], v) for k, v in vae.items())
    for name in ("unet", "trocr"):
        init = init_pipeline_params(cfg, 0, "cpu", (name,))[name]
        assert set(loaded[name]) == set(init)
        assert all(torch.equal(loaded[name][k], v) for k, v in init.items())
    # a subset loads only what is asked for
    only = load_diffusers_layout(str(tmp_path), cfg, "cpu", components=("vae",))
    assert list(only) == ["vae"]


def test_port_export_equals_jax_export(tmp_path, jparams):
    _j_export(tmp_path / "jax", jparams, ema=jparams["unet"])
    cfg = tiny_test_config()
    sd = pipeline_state_dicts(jparams)
    ckpt.export_diffusers_layout(
        str(tmp_path / "port"), unet_params=sd["unet"],
        unet_ema_params=sd["unet"], vae_params=sd["vae"],
        trocr_params=sd["trocr"],
        unet_config=compat.diffusers_unet_config_json(cfg.unet),
        vae_config=compat.diffusers_vae_config_json(cfg.vae),
        trocr_config=compat.vit_config_json(cfg.trocr))
    listing = {d: sorted(os.listdir(tmp_path / "jax" / d)) for d in FILES}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(FILES)
    for sub, fname in FILES.items():
        assert sorted(os.listdir(tmp_path / "port" / sub)) == listing[sub]
        a = _safetensors(tmp_path / "jax" / sub / fname)
        b = _safetensors(tmp_path / "port" / sub / fname)
        assert set(a) == set(b), sub
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        with open(tmp_path / "jax" / sub / "config.json") as f:
            ja = json.load(f)
        with open(tmp_path / "port" / sub / "config.json") as f:
            assert json.load(f) == ja


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64, torch.int64,
                                   torch.uint8, torch.bool])
def test_save_safetensors_reads_back_as_the_library_writes(tmp_path, dtype):
    # the port writes the format itself (no Python-side copy, the
    # interpreter lock released for each write): safetensors' readers take
    # it, and it holds what safetensors' own writer holds
    from safetensors.torch import load_file, save_file

    base = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)) * 100
    sd = {"m": base.to(dtype).clone(), "t": base.t().to(dtype).clone(),
          "scalar": base[0, 0].to(dtype).clone(),
          "empty": torch.zeros(0, 3, dtype=dtype), "params/w": torch.ones(4)}
    compat.save_safetensors(sd, str(tmp_path / "port.safetensors"))
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(tmp_path / "lib.safetensors"))
    with open(tmp_path / "port.safetensors", "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    port = load_file(str(tmp_path / "port.safetensors"))
    lib = load_file(str(tmp_path / "lib.safetensors"))
    assert set(port) == set(lib) == set(sd)
    for k in sd:
        assert port[k].dtype == lib[k].dtype == sd[k].dtype, k
        assert port[k].shape == lib[k].shape == sd[k].shape, k
        assert torch.equal(port[k], lib[k]) and torch.equal(port[k], sd[k]), k
    if dtype != torch.bfloat16:  # numpy has no bfloat16
        arrays = _safetensors(tmp_path / "port.safetensors")
        for k in sd:
            np.testing.assert_array_equal(arrays[k], sd[k].numpy(), err_msg=k)
    assert (os.path.getsize(tmp_path / "port.safetensors")
            <= os.path.getsize(tmp_path / "lib.safetensors"))


@pytest.mark.parametrize("make", [tiny_test_config, small_config,
                                  DiffUTEConfig])
def test_config_json_equals_jax(make):
    from diffute_tpu import config as jconfig

    jcfg = {tiny_test_config: jconfig.tiny_test_config,
            small_config: jconfig.small_config,
            DiffUTEConfig: jconfig.DiffUTEConfig}[make]()
    cfg = make()
    assert (compat.diffusers_unet_config_json(cfg.unet)
            == jckpt.diffusers_unet_config_json(jcfg.unet))
    assert (compat.diffusers_vae_config_json(cfg.vae)
            == jckpt.diffusers_vae_config_json(jcfg.vae))
    assert compat.vit_config_json(cfg.trocr) == jckpt.vit_config_json(jcfg.trocr)


def test_legacy_vae_names_load_equal_in_both(jparams):
    modern = {k: v.numpy() for k, v in vae_state_dict(jparams["vae"]).items()}
    legacy = {}
    for k, v in modern.items():
        for new, old in ((".group_norm.", ".norm."), (".to_q.", ".query."),
                         (".to_k.", ".key."), (".to_v.", ".value."),
                         (".to_out.0.", ".proj_attn.")):
            if ".mid_block.attentions.0" + new in k:
                k = k.replace(new, old)
                if old != ".norm." and v.ndim == 2 and k.endswith(".weight"):
                    v = v[:, :, None, None]  # the (C, C, 1, 1) conv form
        legacy[k] = v
    assert any(".proj_attn." in k for k in legacy)
    port = compat.import_vae_state_dict(legacy)
    via_jax = vae_state_dict(j_import_vae(legacy))
    assert set(port) == set(via_jax) == set(modern)
    for k, v in port.items():
        assert torch.equal(v, via_jax[k]) and np.array_equal(v.numpy(),
                                                             modern[k]), k


def test_trocr_encoder_decoder_checkpoint_loads_equal_in_both(jparams):
    vit = {k: v.numpy() for k, v in trocr_state_dict(jparams["trocr"]).items()}
    wrapped = {f"encoder.{k}": v for k, v in vit.items()}
    wrapped["encoder.pooler.dense.weight"] = np.ones((2, 2), np.float32)
    wrapped["decoder.model.decoder.layers.0.fc1.weight"] = np.ones(
        (2, 2), np.float32)
    for sd in (vit, wrapped):
        port = compat.import_trocr_state_dict(sd)
        via_jax = trocr_state_dict(j_import_trocr(sd))
        assert set(port) == set(via_jax) == set(vit)
        assert all(torch.equal(port[k], via_jax[k]) for k in port)


# ------------------------------------------------ trainer state round trip

def _trainer_config(variant):
    cfg = tiny_test_config()
    bf16 = variant == "bf16_ema_accum"
    opt = dataclasses.replace(cfg.train.optimizer, lr_warmup_steps=2,
                              lr_scheduler="cosine", low_memory_adam=bf16)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, train_batch_size=2,
        gradient_accumulation_steps=2 if bf16 else 1,
        mixed_precision="bf16" if bf16 else "no", use_ema=bf16, seed=4,
        optimizer=opt))


def _batches(cfg, n):
    data = SyntheticSceneDataset(cfg, seed=0)
    accum = cfg.train.gradient_accumulation_steps
    out = []
    for i in range(n):
        b = make_unet_batch([data[2 * accum * i + j] for j in range(2 * accum)],
                            cfg)
        if accum > 1:
            b = {k: v.reshape((accum, 2) + v.shape[1:]) for k, v in b.items()}
        out.append(b)
    return out


@pytest.mark.parametrize("variant", ["fp32", "bf16_ema_accum"])
def test_unet_trainer_save_restore_continues_bit_for_bit(tmp_path, variant):
    cfg = _trainer_config(variant)
    params = init_pipeline_params(cfg, seed=1, device="cpu")

    def trainer():
        return UNetTrainer(cfg, params["unet"], {"vae": params["vae"],
                                                 "trocr": params["trocr"]},
                           device="cpu", total_steps=10)

    batches = _batches(cfg, 2)  # N = 1 step, a save and restore, M = 1
    straight = trainer()
    for b in batches:
        straight.step(b)
    first = trainer()
    first.step(batches[0])
    manager = ckpt.AsyncCheckpointManager(str(tmp_path))
    path = manager.save(first.state.step, first.state_dict())
    manager.wait()
    assert path == str(tmp_path / "checkpoint-1")
    second = trainer()
    second.load_state_dict(ckpt.restore_checkpoint(path))
    _assert_state_equal(first.state_dict(), second.state_dict())
    if second.bf16:  # the compute copy follows the restored masters
        assert all(torch.equal(c, m.bfloat16()) for c, m in
                   zip(second._compute_params, second.state.params))
    second.step(batches[1])
    _assert_state_equal(straight.state_dict(), second.state_dict())


def test_restore_refuses_a_mismatched_state(tmp_path):
    cfg = _trainer_config("fp32")
    params = init_pipeline_params(cfg, seed=1, device="cpu")
    t = UNetTrainer(cfg, params["unet"], {"vae": params["vae"],
                                          "trocr": params["trocr"]},
                    device="cpu")
    state = t.state_dict()
    with pytest.raises(ValueError, match="use_ema"):
        t.load_state_dict({**state, "ema": {"params": {}, "step": 0}})
    del state["params"]["conv_in.weight"]
    with pytest.raises(KeyError, match="conv_in.weight"):
        t.load_state_dict(state)


def test_async_save_snapshots_synchronously_and_reports_errors(tmp_path):
    state = {"params": {"w": torch.ones(3)}, "step": 1, "ema": None}

    def export(path, host):
        with open(os.path.join(path, "exported"), "w") as f:
            f.write(str(float(host["params"]["w"].sum())))

    manager = ckpt.AsyncCheckpointManager(str(tmp_path))
    path = manager.save(1, state, export)
    state["params"]["w"].add_(10)  # the next step updates in place
    manager.wait()
    restored = ckpt.restore_checkpoint(path)
    assert torch.equal(restored["params"]["w"], torch.ones(3))
    assert restored["step"] == 1 and restored["ema"] is None
    with open(os.path.join(path, "exported")) as f:
        assert f.read() == "3.0"
    assert set(manager.times) == {"snapshot_seconds", "write_seconds",
                                  "export_seconds"}

    def broken(path, host):
        raise OSError("disk full")

    manager.save(2, state, broken)
    with pytest.raises(OSError, match="disk full"):
        manager.wait()
    # the failed save never finalized: it is not "latest"
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint-1")


def test_rotation_keeps_the_newest_finalized(tmp_path):
    out = str(tmp_path)
    manager = ckpt.AsyncCheckpointManager(out, total_limit=2)
    for step in (1, 2, 3):
        manager.save(step, {"step": step, "w": torch.zeros(1)})
    manager.wait()
    assert ckpt.list_checkpoints(out) == ["checkpoint-2", "checkpoint-3"]
    # an unfinished directory is never latest, and rotation sweeps it
    os.makedirs(os.path.join(out, "checkpoint-9", "state.tmp"))
    assert ckpt.latest_checkpoint(out).endswith("checkpoint-3")
    assert (ckpt.list_checkpoints(out, finalized_only=True)
            == jckpt.list_checkpoints(out, finalized_only=True)
            == ["checkpoint-2", "checkpoint-3"])
    ckpt.save_checkpoint(out, 4, {"step": 4}, total_limit=1)
    assert ckpt.list_checkpoints(out) == ["checkpoint-4"]


def test_checkpoint_step_and_resolve_resume_as_jax(tmp_path):
    for p in ("/x/y/checkpoint-42", "/x/y/checkpoint-42/", "/x/y/best-model",
              "/x/y/checkpoint-latest", "checkpoint-7"):
        assert ckpt.checkpoint_step(p) == jckpt.checkpoint_step(p)
    assert ckpt.checkpoint_step("/x/y/best-model") == -1
    out = str(tmp_path)
    os.makedirs(os.path.join(out, "checkpoint-3", "state"))
    os.makedirs(os.path.join(out, "checkpoint-5"))  # not finalized
    for resume in (None, "latest", os.path.join(out, "checkpoint-3"),
                   os.path.join(out, "nope")):
        assert (ckpt.resolve_resume(out, resume)
                == jckpt.resolve_resume(out, resume))


# ------------------------------------------------------------- entry points

def _smoke(out, *flags):
    return ["--smoke", "--device", "cpu", "--output_dir", str(out),
            "--dataloader_num_workers", "1", "--report_to", "none", *flags]


def test_run_unet_checkpoints_resumes_and_exits_early(tmp_path, capsys):
    out = tmp_path / "unet"
    run_unet.main(_smoke(out, "--use_ema", "--checkpointing_steps", "1"))
    for step in (1, 2):
        d = out / f"checkpoint-{step}"
        assert sorted(os.listdir(d)) == ["state", "trocr", "unet", "unet_ema",
                                         "vae"]
    with open(out / "checkpoint-2" / "unet" / "config.json") as f:
        assert json.load(f)["in_channels"] == 9
    run = run_unet.prepare(_smoke(out, "--use_ema", "--max_train_steps", "3",
                                  "--resume_from_checkpoint", "latest"))
    assert run.start_step == 2 and run.trainer.state.ema.step == 2
    assert [h["step"] for h in run.train()] == [3]
    capsys.readouterr()
    # the budget is met: the entry point exits from the directory name
    assert run_unet.main(_smoke(out, "--resume_from_checkpoint", "latest",
                                "--max_train_steps", "3")) == []
    assert "done at step 3; nothing to train" in capsys.readouterr().out


def test_early_exit_builds_nothing(tmp_path, capsys):
    # a finalized-looking directory with no state: reaching the restore
    # would crash, so success shows the name alone decided
    out = tmp_path / "vae"
    os.makedirs(out / "checkpoint-7" / "state")
    for main in (run_vae.main, run_unet.main):
        assert main(_smoke(out, "--resume_from_checkpoint", "latest")) == []
        text = capsys.readouterr().out
        assert "done at step 7" in text and "nothing to train" in text
    assert os.listdir(out / "checkpoint-7") == ["state"]


def test_resume_from_renamed_checkpoint_dir(tmp_path, capsys):
    out = tmp_path / "unet"
    run_unet.main(_smoke(out))
    renamed = str(tmp_path / "best-copy")
    shutil.copytree(out / "checkpoint-2", renamed)
    assert run_unet.main(_smoke(out, "--resume_from_checkpoint", renamed,
                                "--max_train_steps", "3"))[-1]["step"] == 3
    text = capsys.readouterr().out
    assert f"resumed from {renamed} at step 2" in text


def test_run_unet_pretrained_takes_stage_one_vae(tmp_path):
    run_vae.main(_smoke(tmp_path / "vae"))
    stage1 = tmp_path / "vae" / "checkpoint-2"
    run = run_unet.prepare(_smoke(tmp_path / "unet", "--pretrained",
                                  str(stage1)))
    exported = compat.load_safetensors(str(stage1 / "vae" / FILES["vae"]))
    frozen = run.trainer.vae.state_dict()
    assert set(exported) == set(frozen)
    assert all(torch.equal(v, frozen[k]) for k, v in exported.items())
    # the UNet was random-init from seed 0, the directory having none
    init = init_pipeline_params(tiny_test_config(), 0, "cpu", ("unet",))["unet"]
    assert torch.equal(run.trainer.state.params_dict()["conv_in.weight"],
                       init["conv_in.weight"])


def test_report_to_tensorboard_writes_events(tmp_path, monkeypatch):
    # torch.utils.tensorboard imports TensorFlow where it is installed
    # (slow); with it missing the writer takes tensorboardX
    pytest.importorskip("tensorboardX")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = tmp_path / "unet"
    run_unet.main(_smoke(out, "--report_to", "tensorboard"))
    events = os.listdir(out / "logs")
    assert any(e.startswith("events.out.tfevents") for e in events)


def test_metric_writer_falls_back_to_stdout(monkeypatch, capsys):
    from diffute_tpu_torch.utils.metrics import MetricWriter

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    w = MetricWriter("unused", report_to="all")
    w.log(3, {"train_loss": torch.tensor(0.25), "grad_norm": 1.5})
    w.close()
    text = capsys.readouterr().out
    assert "tracker 'tensorboard' is not installed" in text
    assert "tracker 'wandb' is not installed" in text
    assert "[step 3] train_loss=0.25000 grad_norm=1.50000" in text


def test_serve_entry_points_take_a_checkpoint(tmp_path, jparams):
    _j_export(tmp_path / "ckpt", jparams)
    image = np.random.RandomState(2).randint(0, 255, (48, 64, 3), np.uint8)
    Image.fromarray(image).save(tmp_path / "in.png")
    cli.main(["--checkpoint", str(tmp_path / "ckpt"), "--device", "cpu",
              "--image", str(tmp_path / "in.png"), "--box", "10,12,40,26",
              "--text", "Hey", "--steps", "3", "--seed", "5",
              "--out", str(tmp_path / "out.png")])
    out = np.asarray(Image.open(tmp_path / "out.png"))
    # the scale came from the checkpoint's config.json: the tiny models
    ref = DiffUTEPipeline(tiny_test_config(), pipeline_state_dicts(jparams),
                          device="cpu").edit(image, (10, 12, 40, 26), "Hey",
                                             num_inference_steps=3, seed=5)[0]
    np.testing.assert_array_equal(out, ref)
    pipe = web.build_pipeline(str(tmp_path / "ckpt"), None, device="cpu")
    assert pipe.config.edit.resolution == tiny_test_config().edit.resolution
    assert torch.equal(pipe.unet.conv_in.weight,
                       pipeline_state_dicts(jparams)["unet"]["conv_in.weight"])
