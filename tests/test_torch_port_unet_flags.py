"""PyTorch port, the UNet's three opt-in kernels at tiny width: each flag
alone and all three, the port against the JAX UNet with the same flags and
the same weights (through the bridge), fp32.

On the CPU both sides compute the kernels' arithmetic without a card: the JAX
ops run their Pallas kernels in interpret mode (the int8 matmul its plain
reference), the port its plain versions.  For int8 the JAX float tree is
quantised once by the JAX package and the SAME int8 leaves go to both sides,
so the tolerance is the float one, not the 5% of weight quantisation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.models import UNet2DCondition as JUNet
from diffute_tpu.ops.quant import convert_dense_params_to_int8
from diffute_tpu.utils.params import init_unet_params

from diffute_tpu_torch.compat import unet_state_dict
from diffute_tpu_torch.config import UNetConfig, tiny_test_config
from diffute_tpu_torch.models import UNet2DCondition
from diffute_tpu_torch.models.layers import (
    GroupNormSiLU,
    QuantLinear,
    ResnetBlock2D,
)
from diffute_tpu_torch.ops import conv_fused, groupnorm, quant
from diffute_tpu_torch.utils.params import build_meta, load_module
from port_threads import torch_threads_per_worker  # noqa: F401

FLAG_SETS = {
    "fused_gn": dict(use_fused_groupnorm=True),
    "fused_conv": dict(use_fused_conv=True),
    "int8": dict(use_int8_weights=True),
    "all": dict(use_fused_groupnorm=True, use_fused_conv=True,
                use_int8_weights=True),
}


@pytest.fixture(scope="module")
def case():
    cfg = j_tiny()
    params = init_unet_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    lat = cfg.edit.resolution // cfg.vae.scale_factor
    x = rng.standard_normal((2, lat, lat, cfg.unet.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((2, cfg.trocr.seq_len,
                               cfg.unet.cross_attention_dim)).astype(np.float32)
    return dict(cfg=cfg, params=params, x=x, ctx=ctx, t=np.int32([7, 500]))


def _jax_forward(case, flags):
    """-> (eps NHWC, the param tree the flagged JAX UNet ran with)."""
    ucfg = dataclasses.replace(case["cfg"].unet, **flags)
    unet = JUNet(ucfg)
    args = (jnp.asarray(case["x"]), jnp.asarray(case["t"]),
            jnp.asarray(case["ctx"]))
    params = case["params"]
    if ucfg.use_int8_weights:
        target = jax.eval_shape(unet.init, jax.random.PRNGKey(0), *args)["params"]
        params = convert_dense_params_to_int8(params, target)
    return np.asarray(unet.apply({"params": params}, *args)), params


def _port_forward(case, flags, state_dict):
    ucfg = dataclasses.replace(tiny_test_config().unet, **flags)
    unet = load_module(UNet2DCondition, ucfg, state_dict, "cpu", torch.float32)
    x = torch.tensor(case["x"].transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        out = unet(x, torch.tensor(case["t"]), torch.tensor(case["ctx"]))
    return out.permute(0, 2, 3, 1).numpy(), unet


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_flagged_unet_matches_jax(case, name, monkeypatch):
    flags = FLAG_SETS[name]
    ref, j_params = _jax_forward(case, flags)
    # count the calls that reach each op's entry (on a card: its kernel)
    calls = {"gn": 0, "conv": 0, "w8": 0}
    import diffute_tpu_torch.models.layers as layers

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(layers, "group_norm_silu",
                        counted("gn", groupnorm.group_norm_silu))
    monkeypatch.setattr(layers, "gn_silu_conv3x3",
                        counted("conv", conv_fused.gn_silu_conv3x3))
    monkeypatch.setattr(layers, "quant_matmul",
                        counted("w8", quant.quant_matmul))
    out, unet = _port_forward(case, flags, unet_state_dict(j_params))
    # fp32 on both sides with identical weights (int8: identical int8 leaves
    # and scales), other summation order: the goldens' tolerance, loosened to
    # 2e-4 for the fused kernels' folded affine
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-4)
    # tiny topology: 8 resnets (16 halves, 17 norms with conv_norm_out), 4
    # transformers with 12 linear layers each (to_k / to_v included: nothing
    # is hoisted here)
    n_conv = 16 if flags.get("use_fused_conv") else 0
    n_gn = (0 if not flags.get("use_fused_groupnorm")
            else 1 if flags.get("use_fused_conv") else 17)
    n_w8 = 48 if flags.get("use_int8_weights") else 0
    assert calls == {"gn": n_gn, "conv": n_conv, "w8": n_w8}
    if flags.get("use_int8_weights"):
        layer = unet.down_blocks[0].attentions[0].proj_in
        assert isinstance(layer, QuantLinear)
        assert layer.weight_q.dtype == torch.int8
        # the time-embedding layers stay float
        assert isinstance(unet.time_embedding.linear_1, torch.nn.Linear)
        assert isinstance(unet.down_blocks[0].resnets[0].time_emb_proj,
                          torch.nn.Linear)


def test_flags_do_not_change_the_float_result_much(case):
    # the same float weights with and without the fused kernels: the kernels
    # compute the unfused function (tests/test_conv_fused.py: 1e-3)
    sd = unet_state_dict(case["params"])
    base, _ = _port_forward(case, {}, sd)
    for name in ("fused_gn", "fused_conv"):
        out, _ = _port_forward(case, FLAG_SETS[name], sd)
        np.testing.assert_allclose(out, base, atol=1e-3, rtol=1e-3)


def test_float_state_dict_is_quantised_at_load(case):
    # a float dict into an int8 model: load_module quantises it, and the
    # result is what the JAX package's conversion of the same tree gives
    sd = unet_state_dict(case["params"])
    ref, j_params = _jax_forward(case, FLAG_SETS["int8"])
    out, unet = _port_forward(case, FLAG_SETS["int8"], sd)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-4)
    bridged = unet_state_dict(j_params)
    loaded = unet.state_dict()
    assert sorted(loaded) == sorted(bridged)
    quantised = [k for k in loaded if k.endswith(".weight_q")]
    assert len(quantised) == 48
    for k in quantised:  # bit for bit the JAX package's int8 leaves and scales
        assert torch.equal(loaded[k], bridged[k]), k
        s = k.replace("weight_q", "weight_scale")
        assert torch.equal(loaded[s], bridged[s]), s


def test_int8_tracks_the_float_unet(case):
    # tests/test_quant.py's measures of the int8 UNet against the float one
    sd = unet_state_dict(case["params"])
    ref, _ = _port_forward(case, {}, sd)
    out, _ = _port_forward(case, FLAG_SETS["int8"], sd)
    rel = np.abs(out - ref).mean() / np.abs(ref).mean()
    cos = (ref * out).sum() / (np.linalg.norm(ref) * np.linalg.norm(out))
    assert rel < 0.05 and cos > 0.999, (rel, cos)


def test_bf16_load_casts_scales_and_keeps_int8(case):
    ucfg = dataclasses.replace(tiny_test_config().unet, use_int8_weights=True,
                               dtype=torch.bfloat16)
    unet = load_module(UNet2DCondition, ucfg, unet_state_dict(case["params"]),
                       "cpu", torch.bfloat16)
    layer = unet.mid_block.attentions[0].transformer_blocks[0].ff.net[2]
    assert layer.weight_q.dtype == torch.int8
    assert layer.weight_scale.dtype == torch.bfloat16
    assert layer.bias.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in unet.parameters())


@pytest.mark.parametrize("flags", [dict(use_fused_groupnorm=True),
                                   dict(use_fused_conv=True),
                                   dict(use_fused_groupnorm=True,
                                        use_fused_conv=True)])
def test_fused_flags_keep_the_state_dict_keys(flags):
    plain = build_meta(UNet2DCondition, tiny_test_config().unet)
    fused = build_meta(UNet2DCondition, dataclasses.replace(
        tiny_test_config().unet, **flags))
    assert list(fused.state_dict()) == list(plain.state_dict())
    assert ({k: v.shape for k, v in fused.state_dict().items()}
            == {k: v.shape for k, v in plain.state_dict().items()})
    res = fused.down_blocks[0].resnets[0]
    assert isinstance(res, ResnetBlock2D)
    # fused_conv takes precedence: its norms stay parameter holders
    assert isinstance(res.norm1, GroupNormSiLU) == (
        "use_fused_conv" not in flags)
    assert isinstance(fused.conv_norm_out, GroupNormSiLU) == (
        "use_fused_groupnorm" in flags)


def test_full_width_flags_construct():
    # the three flags no longer raise, alone or together, at full width
    for flags in FLAG_SETS.values():
        cfg = UNetConfig(use_flash_attention=True, **flags)
        model = build_meta(UNet2DCondition, cfg)
        n_quant = sum(isinstance(m, QuantLinear) for m in model.modules())
        assert n_quant == (192 if cfg.use_int8_weights else 0)
    keys = set(build_meta(UNet2DCondition, UNetConfig()).state_dict())
    q_keys = set(build_meta(UNet2DCondition,
                            UNetConfig(use_int8_weights=True)).state_dict())
    assert len(keys - q_keys) == 192 and len(q_keys - keys) == 2 * 192
