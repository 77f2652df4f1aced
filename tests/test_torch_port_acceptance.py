"""PyTorch port, the weight-day acceptance command against the JAX
package's, at tiny scale on the CPU.

The layout is exported by the JAX package; both commands read it.  Stage 3
(module goldens) holds the port to a JAX-made bundle as it is; stages 4-5
(the composed edit's latents and image) take the JAX key-tree draws
(tests/test_composed_parity.py's ``_pipeline_noise``, under the rbg PRNG
the JAX command sets), fed through the pipeline's ``_draw_noise``.  The
bounds are the command's own (goldens 2e-3, latents 5e-3 of the running
scale, SSIM 0.99).  A bundle the port writes with those draws passes the
JAX command, its own bundle passes the port's, and a bare layout, a vacuous
bundle and one of another scale are rejected as tests/test_acceptance.py
rejects them.
"""

import contextlib
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.eval import acceptance as jacc
from diffute_tpu.train.checkpoint import (
    diffusers_unet_config_json,
    diffusers_vae_config_json,
    export_diffusers_layout,
    vit_config_json,
)
from diffute_tpu.utils import init_pipeline_params as j_init

from diffute_tpu_torch.eval import acceptance
from diffute_tpu_torch.pipeline import DiffUTEPipeline

# pytest puts tests/ itself on sys.path (conftest.py, prepend import mode)
from test_composed_parity import _pipeline_noise

STEPS = ["--model_scale", "tiny", "--steps", "4"]


@contextlib.contextmanager
def rbg():
    """The JAX commands switch the default PRNG to rbg; switch it back."""
    old = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", old)


def feed_jax_draws(monkeypatch, jcfg):
    """Every port pipeline draws what the JAX key tree (rbg) gives."""

    def draw(self, shape, steps, ec, seed):
        b, c, r, _ = shape
        with rbg():
            n_init, n_mask, n_crop, n_blend, n_step = _pipeline_noise(
                jcfg, seed, steps, ec.sampler, (b, r, r, c))

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))

        blend = ec.masked_latent_blend
        return (t(n_init), t(n_mask), t(n_crop) if blend else None,
                t(n_blend) if blend else None,
                t(n_step) if ec.sampler == "ddpm" else None)

    monkeypatch.setattr(DiffUTEPipeline, "_draw_noise", draw)


def export_jax_layout(path, cfg, seed):
    params = j_init(cfg, seed=seed)
    export_diffusers_layout(
        path, unet_params=params["unet"], unet_ema_params=None,
        unet_config=diffusers_unet_config_json(cfg.unet),
        vae_params=params["vae"],
        vae_config=diffusers_vae_config_json(cfg.vae),
        trocr_params=params["trocr"],
        trocr_config=vit_config_json(cfg.trocr))
    return params


def _run(main, tmp_path, *args):
    out = str(tmp_path / "report.json")
    rc = main(["--out", out, *args])
    with open(out) as f:
        return rc, json.load(f)


def _statuses(report):
    return {k: v["status"] for k, v in report["stages"].items()}


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """A JAX-exported tiny layout and a bundle the JAX command made of it."""
    root = tmp_path_factory.mktemp("acceptance")
    path, bundle = str(root / "layout"), str(root / "jax_bundle")
    export_jax_layout(path, j_tiny(), seed=5)
    with rbg():
        assert jacc.main(["--pretrained", path, "--make_reference", bundle,
                          *STEPS]) == 0
    return path, bundle


def test_port_passes_a_jax_bundle(layout, tmp_path, monkeypatch):
    path, bundle = layout
    # stages 1-3 need nothing fed in
    rc, rep = _run(acceptance.main, tmp_path, "--pretrained", path,
                   "--reference_outputs", bundle, "--device", "cpu", *STEPS)
    assert _statuses(rep)["goldens"] == "pass", rep["stages"]["goldens"]
    assert _statuses(rep)["layout"] == "pass"
    assert _statuses(rep)["param_pins"] == "skipped"  # pins: full scale only
    for key, d in rep["stages"]["goldens"].items():
        if isinstance(d, dict):
            assert d["max_err"] <= 1e-4 * d["scale"], (key, d)
    # the port's own draws differ from JAX's: stage 4 must see it
    assert _statuses(rep)["latents"] == "fail" and rc == 1
    # with the JAX draws fed in, every stage passes
    feed_jax_draws(monkeypatch, j_tiny())
    rc, rep = _run(acceptance.main, tmp_path, "--pretrained", path,
                   "--reference_outputs", bundle, "--device", "cpu", *STEPS)
    assert rc == 0 and rep["accepted"], rep["stages"]
    assert _statuses(rep) == {"layout": "pass", "param_pins": "skipped",
                              "goldens": "pass", "latents": "pass",
                              "image": "pass"}
    assert rep["stages"]["latents"]["steps"] == 4
    assert rep["stages"]["image"]["max_lsb"] <= 1


def test_port_bundle_passes_jax_and_itself(layout, tmp_path, monkeypatch):
    path, _ = layout
    bundle = str(tmp_path / "port_bundle")
    feed_jax_draws(monkeypatch, j_tiny())
    rc, rep = _run(acceptance.main, tmp_path, "--pretrained", path,
                   "--make_reference", bundle, "--device", "cpu", *STEPS)
    assert rc == 0 and _statuses(rep)["make_reference"] == "pass"
    assert sorted(os.listdir(bundle)) == sorted(
        [*acceptance.GOLDEN_FILES.values(), acceptance.LATENTS_FILE,
         acceptance.IMAGE_FILE, acceptance.MANIFEST_FILE])
    # the port's bundle in the JAX command: every numeric stage passes
    with rbg():
        rc, rep = _run(jacc.main, tmp_path, "--pretrained", path,
                       "--reference_outputs", bundle, *STEPS)
    assert rc == 0 and rep["accepted"], rep["stages"]
    assert {k: _statuses(rep)[k] for k in ("goldens", "latents", "image")} == {
        "goldens": "pass", "latents": "pass", "image": "pass"}
    # and in the port's own command, with both flags at once
    rc, rep = _run(acceptance.main, tmp_path, "--pretrained", path,
                   "--make_reference", str(tmp_path / "again"),
                   "--reference_outputs", bundle, "--device", "cpu", *STEPS)
    assert rc == 0 and rep["accepted"], rep["stages"]
    assert rep["stages"]["image"]["max_lsb"] == 0


def test_rejects_bare_layout_and_vacuous_bundles(layout, tmp_path):
    path, _ = layout
    # no bundle: layout and pins certified, the numeric stages skipped
    rc, rep = _run(acceptance.main, tmp_path, "--pretrained", path,
                   "--device", "cpu", *STEPS)
    assert rc == 0 and _statuses(rep)["goldens"] == "skipped"
    # a component directory without its weight file fails the layout stage
    bare = tmp_path / "bare"
    shutil.copytree(path, bare)
    os.remove(bare / "vae" / "diffusion_pytorch_model.safetensors")
    rc, rep = _run(acceptance.main, tmp_path, "--pretrained", str(bare),
                   "--device", "cpu", *STEPS)
    assert rc == 1 and not rep["accepted"]
    assert rep["stages"]["layout"]["status"] == "fail"
    assert rep["stages"]["layout"]["missing_weight_files"] == ["vae"]
    # a manifest and no arrays: refused before any model runs
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "manifest.json").write_text(json.dumps({"model_scale": "tiny"}))
    rc, rep = _run(acceptance.main, tmp_path, "--pretrained", path,
                   "--reference_outputs", str(empty), "--device", "cpu",
                   *STEPS)
    assert rc == 1 and rep["stages"]["bundle"]["status"] == "fail"
    # a bundle of another scale: a clean manifest-stage failure
    (empty / "manifest.json").write_text(json.dumps({"model_scale": "small"}))
    rc, rep = _run(acceptance.main, tmp_path, "--pretrained", path,
                   "--reference_outputs", str(empty), "--device", "cpu",
                   *STEPS)
    assert rc == 1 and rep["stages"]["manifest"]["status"] == "fail"
