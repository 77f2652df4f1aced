"""PyTorch port, models: the tiny goldens of tests/test_golden.py through the
weight bridge, the bridge against the JAX package's exporters, and the
full-width parameter counts.

Each golden is recomputed here exactly as tests/test_golden.py makes it
(same init key, same linspace inputs); the JAX params go through
``diffute_tpu_torch.compat`` into the port's module, which must reproduce
the stored array at the goldens' own tolerance (atol 5e-5, rtol 1e-4, fp32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffute_tpu.compat import (
    export_trocr_params,
    export_unet_params,
    export_vae_params,
)
from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.models import AutoencoderKL as JVAE
from diffute_tpu.models import TrOCREncoder as JTrOCR
from diffute_tpu.models import UNet2DCondition as JUNet

from diffute_tpu_torch.compat import (
    trocr_state_dict,
    unet_state_dict,
    vae_state_dict,
)
from diffute_tpu_torch.config import DiffUTEConfig, tiny_test_config
from diffute_tpu_torch.models import (
    AutoencoderKL,
    TrOCREncoder,
    UNet2DCondition,
    count_params,
)
from diffute_tpu_torch.utils import build_meta, init_pipeline_params

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
KEY = dict(impl="threefry2x32")


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, name + ".npy"))


def _nchw(a):
    return torch.tensor(np.asarray(a).transpose(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _port(cls, cfg, state_dict):
    m = cls(cfg).eval()
    m.load_state_dict(state_dict, strict=True)
    return m


@pytest.fixture(scope="module")
def jax_params():
    """The golden-generation params of tests/test_golden.py."""
    cfg = j_tiny()
    x_u = jnp.linspace(-1, 1, 1 * 8 * 8 * 9).reshape(1, 8, 8, 9)
    ctx = jnp.linspace(-1, 1, 1 * 5 * cfg.unet.cross_attention_dim).reshape(
        1, 5, cfg.unet.cross_attention_dim)
    x_i = jnp.linspace(-1, 1, 1 * 32 * 32 * 3).reshape(1, 32, 32, 3)
    # jit only speeds the init up: the draws are those of the eager init
    unet = jax.jit(JUNet(cfg.unet).init)(jax.random.key(42, **KEY), x_u,
                                         jnp.array(0), ctx)
    vae = jax.jit(JVAE(cfg.vae).init)(jax.random.key(42, **KEY), x_i,
                                      jax.random.key(1, **KEY))
    trocr = jax.jit(JTrOCR(cfg.trocr).init)(jax.random.key(42, **KEY), x_i)
    return dict(unet=unet["params"], vae=vae["params"], trocr=trocr["params"],
                x_u=np.asarray(x_u), ctx=np.asarray(ctx), x_i=np.asarray(x_i))


def test_unet_golden(jax_params):
    cfg = tiny_test_config().unet
    model = _port(UNet2DCondition, cfg, unet_state_dict(jax_params["unet"]))
    with torch.no_grad():
        out = model(_nchw(jax_params["x_u"]), torch.tensor(100),
                    torch.tensor(jax_params["ctx"]))
    np.testing.assert_allclose(_nhwc(out), _golden("unet_tiny"),
                               atol=5e-5, rtol=1e-4)


def test_vae_golden(jax_params):
    cfg = tiny_test_config().vae
    model = _port(AutoencoderKL, cfg, vae_state_dict(jax_params["vae"]))
    with torch.no_grad():
        mean, logvar = model.encode(_nchw(jax_params["x_i"]))
        dec = model.decode(mean)
    value = np.concatenate([_nhwc(mean).ravel(), _nhwc(logvar).ravel(),
                            _nhwc(dec).ravel()])
    np.testing.assert_allclose(value, _golden("vae_tiny"), atol=5e-5, rtol=1e-4)


def test_trocr_golden(jax_params):
    cfg = tiny_test_config().trocr
    model = _port(TrOCREncoder, cfg, trocr_state_dict(jax_params["trocr"]))
    with torch.no_grad():
        out = model(_nchw(jax_params["x_i"]))
    np.testing.assert_allclose(out.numpy(), _golden("trocr_tiny"),
                               atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("name,bridge,export,cls", [
    ("unet", unet_state_dict, export_unet_params, UNet2DCondition),
    ("vae", vae_state_dict, export_vae_params, AutoencoderKL),
    ("trocr", trocr_state_dict, export_trocr_params, TrOCREncoder),
])
def test_bridge_matches_jax_export_and_loads_strict(jax_params, name, bridge,
                                                    export, cls):
    ours = bridge(jax_params[name])
    ref = export(jax_params[name])
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value),
                                      err_msg=key)
    model = cls(getattr(tiny_test_config(), name))
    model.load_state_dict(ours, strict=True)
    # the random init makes the same names and shapes as the module
    init = init_pipeline_params(tiny_test_config(), seed=0, device="cpu")[name]
    assert {k: v.shape for k, v in init.items()} == \
        {k: v.shape for k, v in ours.items()}


@pytest.mark.parametrize("cls,field,expected", [
    (UNet2DCondition, "unet", 865_925_124),   # SD2-inpainting UNet
    (AutoencoderKL, "vae", 83_653_863),       # SD2 VAE
    (TrOCREncoder, "trocr", 303_690_752),     # ViT-large, no pooler
])
def test_full_config_param_counts(cls, field, expected):
    model = build_meta(cls, getattr(DiffUTEConfig(), field))
    assert count_params(model) == expected
