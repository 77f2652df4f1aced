"""PyTorch port, the other serving modes of ``DiffUTEPipeline``:
``edit_multi``, ``edit_batch``, ``edit_stream`` and ``edit_profiled`` against
the JAX package's methods, at tiny width on the CPU.

Both sides get the same weights (through the bridge), the same scenes and
the JAX key-tree noise draws (tests/test_composed_parity.py's
``_pipeline_noise``, at a batch of B), which the port takes through its
``_draw_noise`` seam.  Bounds as in tests/test_torch_port_pipeline.py: every
step's latents within 5e-3 of the running scale, the pasted image within
1 LSB.  The streaming cases hold the port to its own sequential ``edit()``
bit for bit, as tests/test_pipeline_stream.py holds the JAX package.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.ops import flash_attention as jfa
from diffute_tpu.pipeline import DiffUTEPipeline as JPipeline
from diffute_tpu.pipeline.crop import paste_back
from diffute_tpu.text import trocr_preprocess_host
from diffute_tpu.utils import init_pipeline_params as j_init

from diffute_tpu_torch.compat import pipeline_state_dicts
from diffute_tpu_torch.config import tiny_test_config
from diffute_tpu_torch.pipeline import DiffUTEPipeline

# pytest puts tests/ itself on sys.path (conftest.py, prepend import mode)
from test_composed_parity import _pipeline_noise

tfa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")

STEPS, SEED = 4, 0


def _with(cfg, res=None, flash=False):
    edit = cfg.edit if res is None else dataclasses.replace(
        cfg.edit, resolution=res)
    return dataclasses.replace(
        cfg, edit=edit,
        unet=dataclasses.replace(cfg.unet, use_flash_attention=flash))


def _pipes(jparams, res=None, flash=False):
    return (JPipeline(_with(j_tiny(), res, flash), jparams),
            DiffUTEPipeline(_with(tiny_test_config(), res, flash),
                            pipeline_state_dicts(jparams), device="cpu"))


@pytest.fixture(scope="module")
def jparams():
    return j_init(j_tiny(), seed=3)


@pytest.fixture(scope="module")
def pipes(jparams):
    return _pipes(jparams)


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, -3)))


def _feed_jax_draws(monkeypatch, jpipe, tpipe):
    """The port draws what the JAX key tree gives for the same seed."""

    def draw(shape, steps, ec, seed):
        b, c, r, _ = shape
        n_init, n_mask, n_crop, n_blend, n_step = _pipeline_noise(
            jpipe.config, seed, steps, ec.sampler, (b, r, r, c))
        blend = ec.masked_latent_blend
        return (_nchw(n_init), _nchw(n_mask), _nchw(n_crop) if blend else None,
                _nchw(n_blend) if blend else None,
                _nchw(n_step) if ec.sampler == "ddpm" else None)

    monkeypatch.setattr(tpipe, "_draw_noise", draw)


def _record_trajectory(monkeypatch, tpipe):
    """Have the port's loop keep the latents after every step."""
    kept = {}
    real = tpipe._device_loop

    def loop(*a, **kw):
        latents, kept["traj"] = real(*a, **kw, return_trajectory=True)
        return latents

    monkeypatch.setattr(tpipe, "_device_loop", loop)
    return kept


def _jax_trajectory(jpipe, regions, steps):
    """The JAX staged programs over a batch of prepared regions, the loop
    emitting every step: ((steps, B, r, r, 4) latents, (B, R, R, 3) uint8
    crops)."""
    dummy = jnp.zeros((1, 1, 1, 3), jnp.uint8)
    glyph = trocr_preprocess_host([r["glyph"] for r in regions],
                                  jpipe.config.trocr)
    inputs = (dummy, jnp.asarray(np.stack([r["mask512"] for r in regions])),
              jnp.asarray(np.stack([r["masked512"] for r in regions])),
              jnp.asarray(glyph))
    sig = (steps, "ddim", 1.0, False, 1)
    jpipe._get_compiled(*sig)
    prep, _, _ = jpipe._stages[sig]
    *prepped, k_loop = prep(jpipe.params, *inputs, dummy, np.int32(SEED))
    loop = jax.jit(functools.partial(jpipe._device_loop, *sig,
                                     return_trajectory=True))
    lat, traj = loop(jpipe.params["unet"], *prepped, k_loop)
    return np.asarray(traj), np.asarray(jpipe._decode(jpipe.params["vae"],
                                                      lat))


def _jax_edit(jpipe, image, box, text, traj):
    """One edit by the JAX package's host prep, staged programs and
    paste-back (what its ``edit()`` chains), its per-step latents held
    against ``traj``: (pasted image, mask)."""
    region, mask = jpipe._prepare_region(image, box, text,
                                         jpipe.config.edit.resolution, None)
    j_traj, crops = _jax_trajectory(jpipe, [region], STEPS)
    _assert_steps_close(traj, j_traj)
    return paste_back(image, crops[0], region["x_s"], region["y_s"],
                      region["crop_scale"], region["location"]), mask


def _assert_steps_close(traj, j_traj):
    assert traj.shape[0] == j_traj.shape[0]
    for i in range(traj.shape[0]):
        ref = j_traj[i].transpose(0, 3, 1, 2)
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(traj[i].numpy() - ref).max())
        assert err <= 5e-3 * scale, f"step {i}: {err:.2e} vs {scale:.2f}"


def _assert_within_1_lsb(out, ref):
    assert out.dtype == np.uint8 and out.shape == ref.shape
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, f"uint8 image differs by {diff.max()} LSB"


def test_edit_multi_matches_jax(pipes, monkeypatch):
    jpipe, tpipe = pipes
    image = np.random.RandomState(0).randint(0, 255, (200, 300, 3), np.uint8)
    regions = [((20, 20, 90, 45), "aa"), ((150, 120, 260, 150), "bb"),
               ((40, 140, 110, 170), "cc")]
    _feed_jax_draws(monkeypatch, jpipe, tpipe)
    kept = _record_trajectory(monkeypatch, tpipe)
    out = tpipe.edit_multi(image, regions, num_inference_steps=STEPS,
                           seed=SEED)
    j_out = jpipe.edit_multi(image, regions, num_inference_steps=STEPS,
                             seed=SEED)
    prepped = [jpipe._prepare_region(image, box, text,
                                     jpipe.config.edit.resolution, None)[0]
               for box, text in regions]
    _assert_steps_close(kept["traj"], _jax_trajectory(jpipe, prepped,
                                                      STEPS)[0])
    _assert_within_1_lsb(out, j_out)
    # only the boxes' pixels changed, and each box did
    changed = (out != image).any(-1)
    union = np.zeros(image.shape[:2], bool)
    for (x1, y1, x2, y2), _ in regions:
        assert changed[y1:y2, x1:x2].any()
        union[y1:y2, x1:x2] = True
    assert not (changed & ~union).any()


def test_edit_batch_matches_jax(pipes, monkeypatch):
    jpipe, tpipe = pipes
    rng = np.random.RandomState(1)
    items = [(rng.randint(0, 255, (150, 200, 3), np.uint8),
              (30 + 5 * i, 40, 120, 70 + i), f"t{i}") for i in range(3)]
    _feed_jax_draws(monkeypatch, jpipe, tpipe)
    kept = _record_trajectory(monkeypatch, tpipe)
    outs = tpipe.edit_batch(items, num_inference_steps=STEPS, seed=SEED)
    j_outs = jpipe.edit_batch(items, num_inference_steps=STEPS, seed=SEED)
    prepped = [jpipe._prepare_region(img, box, text,
                                     jpipe.config.edit.resolution, None)[0]
               for img, box, text in items]
    _assert_steps_close(kept["traj"], _jax_trajectory(jpipe, prepped,
                                                      STEPS)[0])
    assert len(outs) == len(j_outs) == 3
    for out, j_out, (img, _, _) in zip(outs, j_outs, items):
        _assert_within_1_lsb(out, j_out)
        assert (out != img).any()


def test_batch_of_one_equals_edit(pipes):
    _, tpipe = pipes
    img = np.random.RandomState(2).randint(0, 255, (150, 200, 3), np.uint8)
    a, _ = tpipe.edit(img, (30, 40, 120, 70), "x", num_inference_steps=2)
    outs = tpipe.edit_batch([(img, (30, 40, 120, 70), "x")],
                            num_inference_steps=2)
    np.testing.assert_array_equal(a, outs[0])
    multi = tpipe.edit_multi(img, [((30, 40, 120, 70), "x")],
                             num_inference_steps=2)
    np.testing.assert_array_equal(a, multi)


def test_batched_guidance_slots_independent(pipes):
    # an item's output does not depend on its neighbour's text, also with
    # the [cond; uncond] pair stacked into one batch-2B pass
    _, tpipe = pipes
    ec = dataclasses.replace(tpipe.config.edit, guidance_scale=2.5)
    rng = np.random.RandomState(5)
    img_a, img_b = (rng.randint(0, 255, (150, 200, 3)).astype(np.uint8)
                    for _ in range(2))
    box = (30, 40, 120, 70)
    out_x = tpipe.edit_batch([(img_a, box, "aa"), (img_b, box, "bb")],
                             num_inference_steps=3, edit_config=ec)
    out_y = tpipe.edit_batch([(img_a, box, "aa"), (img_b, box, "zz")],
                             num_inference_steps=3, edit_config=ec)
    np.testing.assert_array_equal(out_x[0], out_y[0])
    assert (out_x[1] != out_y[1]).any()


def _stream_items(n):
    rng = np.random.RandomState(3)
    return [(rng.randint(0, 256, (48, 64, 3)).astype(np.uint8),
             (10 + i, 12, 30 + i, 24), f"t{i}") for i in range(n)]


@pytest.mark.parametrize("depth", [2, 1])
def test_edit_stream_equals_sequential_edits(pipes, depth):
    _, tpipe = pipes
    items = _stream_items(3)
    seq = [tpipe.edit(img, box, text, num_inference_steps=4)[0]
           for img, box, text in items]
    streamed = list(tpipe.edit_stream(items, num_inference_steps=4,
                                      depth=depth))
    assert len(streamed) == len(seq)
    for a, b in zip(streamed, seq):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_edit_stream_pulls_at_most_depth_ahead(pipes, depth):
    _, tpipe = pipes
    pulled = []

    def lazy():
        for i, item in enumerate(_stream_items(4)):
            pulled.append(i)
            yield item

    stream = tpipe.edit_stream(lazy(), num_inference_steps=2, depth=depth)
    next(stream)
    assert len(pulled) == depth


def test_edit_stream_of_nothing_yields_nothing(pipes):
    _, tpipe = pipes
    assert list(tpipe.edit_stream([], num_inference_steps=4)) == []


def test_edit_stream_matches_jax_stream(pipes, monkeypatch):
    jpipe, tpipe = pipes
    items = _stream_items(2)
    _feed_jax_draws(monkeypatch, jpipe, tpipe)
    outs = list(tpipe.edit_stream(items, num_inference_steps=STEPS, seed=SEED))
    j_outs = list(jpipe.edit_stream(items, num_inference_steps=STEPS,
                                    seed=SEED))
    for out, j_out in zip(outs, j_outs):
        _assert_within_1_lsb(out, j_out)


def test_edit_profiled_returns_the_stage_split(pipes):
    _, tpipe = pipes
    img, box, text = _stream_items(1)[0]
    ref, ref_mask = tpipe.edit(img, box, text, num_inference_steps=3)
    out, mask, stats = tpipe.edit_profiled(img, box, text,
                                           num_inference_steps=3)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(mask, ref_mask)
    for key in ("host_prep_s", "prep_s", "loop_s", "decode_s", "paste_s"):
        assert stats[key] > 0
    flops = stats["flops"]
    assert set(flops) == {"prep", "loop", "decode", "total"}
    assert flops["total"] == flops["prep"] + flops["loop"] + flops["decode"]
    # three UNet passes dominate the tiny edit
    assert flops["loop"] > flops["prep"] > 0 and flops["decode"] > 0
    _, _, more = tpipe.edit_profiled(img, box, text, num_inference_steps=6)
    # twice the passes, the cross-attention K/V still projected once
    assert 1.9 * flops["loop"] < more["flops"]["loop"] < 2 * flops["loop"]
    assert more["flops"]["decode"] == flops["decode"]


def test_non_power_of_two_latent_matches_jax(jparams, monkeypatch):
    # resolution 24 is a 12 x 12 latent at the tiny VAE's factor of 2 (what
    # 96 is at the full VAE's 8): crop, mask downsample, the UNet's 12 -> 6
    # -> 12 and the paste-back all see a size that is no power of two
    jpipe, tpipe = _pipes(jparams, res=24)
    image = np.random.RandomState(7).randint(0, 255, (90, 130, 3), np.uint8)
    box, text = (35, 30, 100, 52), "Hey"
    _feed_jax_draws(monkeypatch, jpipe, tpipe)
    kept = _record_trajectory(monkeypatch, tpipe)
    out, mask = tpipe.edit(image, box, text, num_inference_steps=STEPS,
                           seed=SEED)
    assert kept["traj"].shape[-2:] == (12, 12)
    j_out, j_mask = _jax_edit(jpipe, image, box, text, kept["traj"])
    _assert_within_1_lsb(out, j_out)
    np.testing.assert_array_equal(mask, j_mask * 255)


def test_pipelined_forward_edit_matches_jax(jparams, monkeypatch):
    # resolution 64 is a 32 x 32 latent: 1024 tokens in the top
    # self-attentions, 16 kv tiles of the port's deferred-softmax forward.
    # The switch is on in both packages (at 1024 keys the JAX dispatcher
    # picks one 1024-wide kv block and so keeps its standard kernel; the
    # two forwards compute one function)
    monkeypatch.setattr(jfa, "PIPELINE_FWD", True)
    monkeypatch.setattr(tfa, "PIPELINE_FWD", True)
    jpipe, tpipe = _pipes(jparams, res=64, flash=True)
    calls = []
    real = tfa.flash_fwd_pipelined_reference
    monkeypatch.setattr(tfa, "flash_fwd_pipelined_reference",
                        lambda *a: calls.append(1) or real(*a))
    image = np.random.RandomState(8).randint(0, 255, (64, 64, 3), np.uint8)
    box, text = (8, 12, 40, 30), "Hi"
    _feed_jax_draws(monkeypatch, jpipe, tpipe)
    kept = _record_trajectory(monkeypatch, tpipe)
    out, _ = tpipe.edit(image, box, text, num_inference_steps=STEPS, seed=SEED)
    # 3 self-attentions at 1024 tokens per UNet pass took the pipelined entry
    assert len(calls) == 3 * STEPS
    _assert_within_1_lsb(out, _jax_edit(jpipe, image, box, text,
                                        kept["traj"])[0])



def test_cli_takes_the_switch_and_the_resolution(tmp_path, monkeypatch):
    from PIL import Image

    from diffute_tpu_torch.serve import cli

    monkeypatch.setattr(tfa, "PIPELINE_FWD", False)
    src = np.random.RandomState(5).randint(0, 256, (96, 128, 3), np.uint8)
    Image.fromarray(src).save(tmp_path / "in.png")
    args = ["--image", str(tmp_path / "in.png"), "--box", "40,30,90,44",
            "--text", "Hey", "--steps", "2", "--tiny", "--device", "cpu",
            "--out", str(tmp_path / "out.png")]
    cli.main(args + ["--pipeline-fwd"])
    assert tfa.PIPELINE_FWD is True
    cli.main(args)  # the default turns it off again
    assert tfa.PIPELINE_FWD is False
    with pytest.raises(SystemExit):  # 512, 768 or 1024 only
        cli.main(args + ["--res", "640"])
