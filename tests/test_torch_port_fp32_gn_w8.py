"""PyTorch port, GroupNorm+SiLU and the int8-weight matmul on fp32 inputs
(``csrc/groupnorm.cu``'s fp32 entries, ``csrc/quant_fp32.cu``) on the CPU.

The kernels run only on a card (``chip_smoke.py`` phase 3g and the
``cuda`` cases of ``test_torch_port_groupnorm.py`` and
``test_torch_port_quant.py``).  Here: the fp32 plan the GroupNorm kernels
launch with, the tiled plain version of their merge at that plan against
float64 and the JAX op, the wrappers' dtype rule, a plain emulation of the
int8 kernel's two TF32 products against float64, the fp32 bias, and the
slice as a whole at tiny width: an fp32 edit with ``use_fused_groupnorm``
and ``use_int8_weights`` and an fp32 stage-2 step with
``use_fused_groupnorm``, against the JAX package with the same weights
(through the bridge) and the same draws (JAX: the Pallas GroupNorm kernel in
interpret mode, the int8 matmul's plain reference; the port on the CPU: the
kernels' plain versions).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.ops.groupnorm import _VMEM_SLAB_LIMIT, _xla_gn_silu
from diffute_tpu.ops.groupnorm import group_norm_silu as j_group_norm_silu
from diffute_tpu.pipeline import DiffUTEPipeline as JPipeline
from diffute_tpu.pipeline.regions import generate_mask, make_masked_image
from diffute_tpu.text import render_glyph, trocr_preprocess_host
from diffute_tpu.train.optim import build_optimizer as j_build_optimizer
from diffute_tpu.train.state import TrainState as JTrainState
from diffute_tpu.train.unet_train import make_unet_train_step
from diffute_tpu.utils import init_pipeline_params as j_init

from diffute_tpu_torch.compat import pipeline_state_dicts
from diffute_tpu_torch.config import tiny_test_config
from diffute_tpu_torch.ops.conv_fused import KERNEL_DTYPES
from diffute_tpu_torch.ops.flash_attention import round_tf32
from diffute_tpu_torch.ops.groupnorm import (
    MAX_SMEM,
    _check_x,
    gn_plan,
    group_norm_silu,
    group_norm_silu_from_stats,
    group_norm_silu_reference,
    group_norm_stats,
    group_norm_stats_reference,
    group_norm_stats_tiled_reference,
)
from diffute_tpu_torch.ops.quant import (
    quant_matmul,
    quant_matmul_reference,
    quant_matmul_tf32_reference,
    quantize_per_channel,
    w8_fp32_plan,
)
from diffute_tpu_torch.pipeline import DiffUTEPipeline

# pytest puts tests/ itself on sys.path (conftest.py, prepend import mode)
from test_composed_parity import _pipeline_noise
from test_torch_port_groupnorm_plan import NORM_SHAPES
from test_torch_port_train import RES as TRAIN_RES
from test_torch_port_train import _batch, _draws, _frozen, _port_trainer

FLAGS = dict(use_fused_groupnorm=True, use_int8_weights=True)


# ---- the fp32 plan of the GroupNorm kernels

def _check_fp32_plan(b, c, h, w, groups=32):
    p = gn_plan(b, c, h, w, groups, 4)
    cpg = c // groups
    assert p["per_vec"] == 4 and p["n_vec"] * 4 == cpg * h * w
    # every vector covered, no piece empty
    assert p["per"] * p["cluster"] >= p["n_vec"]
    assert p["n_vec"] - p["per"] * (p["cluster"] - 1) >= 1
    assert p["smem"] == 16 * p["staged"] + 8 * cpg <= MAX_SMEM
    # one read exactly where the whole piece fits the shared memory
    assert p["one_read"] == (16 * p["per"] + 8 * cpg <= MAX_SMEM)
    assert p["staged"] == (p["per"] if p["one_read"] else
                           (MAX_SMEM - 8 * cpg) // 16)
    return p


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("res", [512, 768, 1024])
def test_fp32_plan_at_every_norm_shape_of_a_flagged_pass(res, batch):
    for c, hw in NORM_SHAPES:
        hw = hw * res // 512
        p = _check_fp32_plan(batch, c, hw, hw)
        # a 16-byte vector holds 4 fp32 values: twice bf16's vectors
        assert p["n_vec"] == 2 * gn_plan(batch, c, hw, hw, 32)["n_vec"]


def test_fp32_plan_reads_part_of_the_largest_groups_twice():
    # 1024^2's fused_gn-alone shape: a 1.97 MB group, 246 KB a block of 8
    p = _check_fp32_plan(1, 960, 128, 128)
    assert p["cluster"] == 8 and not p["one_read"]
    assert 16 * p["per"] == 245760 > MAX_SMEM
    # the same shape in bf16 fits, and so does every 512^2 shape in fp32
    assert gn_plan(1, 960, 128, 128, 32)["one_read"]
    assert all(_check_fp32_plan(1, c, hw, hw)["one_read"]
               for c, hw in NORM_SHAPES)


def test_fp32_plan_rejects_what_its_vectors_cannot_cover():
    with pytest.raises(ValueError):  # (C/G)*H*W = 6: not whole fp32 vectors
        gn_plan(1, 32, 2, 3, 32, 4)
    with pytest.raises(ValueError):
        gn_plan(1, 32, 8, 8, 32, 8)
    assert gn_plan(1, 32, 2, 2, 32, 4)["n_vec"] == 1  # bf16 would refuse it


def _case(shape_nhwc, seed, mean):
    rng = np.random.RandomState(seed)
    c = shape_nhwc[-1]
    x = (rng.standard_normal(shape_nhwc) + mean).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape,ranks,mean", [
    ((1, 16, 16, 1280), 8, 0.0),  # one block in bf16, a cluster of 8 in fp32
    ((1, 16, 16, 1280), 8, 100.0),
    ((2, 32, 32, 640), 4, 0.0),
    ((2, 32, 32, 640), 4, 100.0),
    ((1, 128, 128, 960), 8, 0.0),  # part of each piece read twice
])
def test_fp32_tiled_reference_matches_float64_and_jax(shape, ranks, mean):
    x, scale, bias = _case(shape, seed=ranks, mean=mean)
    xt = torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    plan = gn_plan(*xt.shape, 32, 4)
    assert plan["cluster"] == ranks
    mean_t, rstd_t = group_norm_stats_tiled_reference(xt, 32, 1e-5)
    # float64 numpy: fp32 statistics, the mean subtracted before squaring:
    # the mean to 1e-6 of max(1, |mean|), rstd to 1e-5 relative
    xd = x.astype(np.float64).transpose(0, 3, 1, 2).reshape(shape[0], 32, -1)
    mu = xd.mean(axis=2)
    var = ((xd - mu[..., None]) ** 2).mean(axis=2)
    np.testing.assert_allclose(mean_t.numpy(), mu, rtol=0,
                               atol=1e-6 * max(1.0, mean))
    np.testing.assert_allclose(rstd_t.numpy(), 1 / np.sqrt(var + 1e-5),
                               rtol=1e-5)
    # the pieces the plan folds: rank 0 alone is the first piece
    run = plan["per_vec"] * plan["per"]
    first = xt.reshape(shape[0] * 32, -1)[:, :run].double()
    mean0, _ = group_norm_stats_tiled_reference(xt, 32, 1e-5, ranks=[0])
    np.testing.assert_allclose(mean0.numpy().ravel(),
                               first.mean(dim=1).numpy(), rtol=0,
                               atol=1e-6 * max(1.0, mean))
    # the JAX op on the same input, as it takes it: its Pallas kernel
    # (interpret mode) where the slab fits VMEM and the mean is 0, else the
    # XLA function (two-pass, as the port at every shape): 1e-4
    y = group_norm_silu_from_stats(xt, torch.tensor(scale), torch.tensor(bias),
                                   mean_t, rstd_t).permute(0, 2, 3, 1).numpy()
    fits = np.prod(shape[1:]) * 4 <= _VMEM_SLAB_LIMIT
    if fits and mean == 0.0:
        with pltpu.force_tpu_interpret_mode():
            ref = j_group_norm_silu(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), 32, 1e-5)
    else:
        ref = _xla_gn_silu(jnp.asarray(x), jnp.asarray(scale),
                           jnp.asarray(bias), 32, 1e-5)
    np.testing.assert_allclose(y, np.asarray(ref), atol=1e-4, rtol=1e-4)


# ---- the wrappers' dtype rule

def _on_card(t):
    """A stand-in that the wrapper's checks see as ``t`` on the card."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=t.dtype,
                                 dim=t.dim, shape=t.shape,
                                 is_contiguous=t.is_contiguous,
                                 data_ptr=lambda: 0)


def test_gn_kernels_take_bf16_and_fp32_and_refuse_fp16_and_fp64():
    x = torch.zeros((1, 32, 4, 4))
    for dtype in (torch.bfloat16, torch.float32):
        _check_x(_on_card(x.to(dtype)), 32, "GroupNorm+SiLU")
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="takes bf16 or fp32"):
            _check_x(_on_card(x.to(dtype)), 32, "GroupNorm+SiLU")
    # the fused conv's wrapper takes fp32 too (csrc/conv_fused_fp32.cu)
    for dtype in KERNEL_DTYPES:
        _check_x(_on_card(x.to(dtype)), 32, "GN+SiLU+conv3x3", KERNEL_DTYPES)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="takes bf16 or fp32"):
            _check_x(_on_card(x.to(dtype)), 32, "GN+SiLU+conv3x3",
                     KERNEL_DTYPES)


def test_a_cpu_tensor_gets_the_plain_version_in_fp32():
    x, scale, bias = _case((2, 4, 4, 64), seed=1, mean=0.0)
    xt = torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    g, b = torch.tensor(scale), torch.tensor(bias)
    launches = group_norm_silu.launches, group_norm_stats.launches
    y = group_norm_silu(xt, g, b, 8, 1e-5)
    assert y.dtype == torch.float32
    assert torch.equal(y, group_norm_silu_reference(xt, g, b, 8, 1e-5))
    stats = group_norm_stats(xt, 8, 1e-5)
    ref = group_norm_stats_reference(xt, 8, 1e-5)
    assert all(torch.equal(a, r) for a, r in zip(stats, ref))
    assert (group_norm_silu.launches, group_norm_stats.launches) == launches


# ---- the int8 matmul on fp32 x

def test_tf32_split_is_exact_to_2_pow_minus_22():
    x = torch.tensor(np.random.RandomState(2).standard_normal(4096),
                     dtype=torch.float32)
    hi = round_tf32(x)
    lo = round_tf32(x - hi)
    for part in (hi, lo):  # TF32 values: the 13 low mantissa bits are 0
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rest = (x.double() - hi.double() - lo.double()).abs() / x.double().abs()
    assert rest.max().item() <= 2.0 ** -22


@pytest.mark.parametrize("m,k,n", [(64, 1280, 1280), (577, 1024, 320)])
def test_two_tf32_products_are_as_close_to_fp64_as_fp32(m, k, n):
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32)
    q, s = quantize_per_channel(torch.tensor(
        rng.standard_normal((n, k)) * k ** -0.5, dtype=torch.float32))
    ref64 = (x.double() @ q.double().t()) * s.double()

    def rel(y):
        return ((y.double() - ref64).norm() / ref64.norm()).item()

    # hi and lo products: about 1e-7 from fp64 (the plain fp32 product
    # 3e-7), far inside the kernel's 1e-5 contract; hi alone (TF32 on x)
    # about 2e-4, far outside it: the contract tells the two apart
    two, plain = rel(quant_matmul_tf32_reference(x, q, s)), rel(
        quant_matmul_reference(x, q, s))
    assert two <= 1e-6 and plain <= 1e-6
    assert rel(quant_matmul_tf32_reference(x, q, s, products=1)) > 1e-5


def test_fp32_quant_matmul_keeps_the_bias_in_fp32():
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.standard_normal((5, 32)), dtype=torch.float32)
    q, s = quantize_per_channel(torch.tensor(rng.standard_normal((8, 32)),
                                             dtype=torch.float32))
    # a bias that bf16 cannot hold: 1 + 2^-12
    bias = torch.full((8,), 1.0 + 2.0 ** -12)
    y = quant_matmul(x, q, s, bias)
    assert y.dtype == torch.float32
    prod = (x @ q.float().t()) * s[None, :]
    assert torch.equal(y, prod + bias)
    assert not torch.equal(y, prod + bias.bfloat16().float())
    # and the kernel's emulation adds it as the plain version does
    assert torch.equal(quant_matmul_tf32_reference(x, q, s, bias),
                       quant_matmul_tf32_reference(x, q, s) + bias)


@pytest.mark.parametrize("m,k,n", [(4096, 320, 320), (64, 5120, 1280),
                                   (1000, 640, 200), (3, 48, 10)])
def test_fp32_plan_covers_the_output(m, k, n):
    p = w8_fp32_plan(m, n, k)
    assert p["blocks"] * p["block_m"] * p["block_n"] >= m * n
    assert p["tiles"] == -(-m // 64) * -(-n // 64) and p["splits"] == 1
    assert p["k_tiles"] * 32 >= k


# ---- the slice at tiny width against the JAX package

@pytest.fixture(scope="module")
def jparams():
    return j_init(j_tiny(), seed=3)


def test_fp32_fused_gn_int8_edit_matches_jax(jparams):
    fp32_edit_against_jax(jparams, FLAGS)


def fp32_edit_against_jax(jparams, flags):
    """A 3-step fp32 edit with the UNet ``flags`` on, the port on the CPU
    against the JAX pipeline with the same weights and draws."""
    steps, seed = 3, 0
    jcfg = dataclasses.replace(j_tiny(), unet=dataclasses.replace(
        j_tiny().unet, **flags))
    tcfg = dataclasses.replace(tiny_test_config(), unet=dataclasses.replace(
        tiny_test_config().unet, **flags))
    assert jcfg.unet.dtype == jnp.float32 and tcfg.unet.dtype == torch.float32
    jpipe = JPipeline(jcfg, jparams)
    # both sides quantise the same float weights at load: the same int8
    # leaves and scales, so the float bounds hold
    tpipe = DiffUTEPipeline(tcfg, pipeline_state_dicts(jparams), device="cpu")
    res = jcfg.edit.resolution
    rng = np.random.RandomState(11)
    image = rng.randint(0, 256, (res, res, 3), np.uint8)
    mask = generate_mask((res, res), np.int32([8, 12, 24, 20]))
    masked = make_masked_image(image, mask)
    glyph = trocr_preprocess_host([render_glyph("Hi", jcfg.glyph)], jcfg.trocr)

    dummy = jnp.zeros((1, 1, 1, 3), jnp.uint8)
    inputs = (dummy, jnp.asarray(mask[None]), jnp.asarray(masked[None]),
              jnp.asarray(glyph))
    sig = (steps, "ddim", 1.0, False, 1)
    jpipe._get_compiled(*sig)
    prep, _, _ = jpipe._stages[sig]
    *prepped, k_loop = prep(jpipe.params, *inputs, dummy, np.int32(seed))
    loop = jax.jit(functools.partial(jpipe._device_loop, *sig,
                                     return_trajectory=True))
    j_lat, j_traj = loop(jpipe.params["unet"], *prepped, k_loop)
    j_img = np.asarray(jpipe._decode(jpipe.params["vae"], j_lat))[0]
    j_traj = np.asarray(j_traj)

    r = res // jcfg.vae.scale_factor
    n_init, n_mask, *_ = _pipeline_noise(jcfg, seed, steps, "ddim",
                                         (1, r, r, 4))

    def nchw(a):
        return torch.tensor(np.asarray(a).transpose(0, 3, 1, 2))

    with torch.inference_mode():
        prepped = tpipe._device_prep(
            torch.from_numpy(mask[None]), torch.from_numpy(masked[None]),
            torch.from_numpy(glyph), nchw(n_init), nchw(n_mask))
        lat, traj = tpipe._device_loop(steps, *prepped, return_trajectory=True)
        img = tpipe._device_decode(lat)[0].numpy()

    # per-step latents within 5e-3 of the running scale, the image within 1
    # LSB: tests/test_torch_port_pipeline.py's bounds
    for i in range(steps):
        ref = j_traj[i].transpose(0, 3, 1, 2)
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(traj[i].numpy() - ref).max())
        assert err <= 5e-3 * scale, f"step {i}: {err:.2e} vs scale {scale:.2f}"
    diff = np.abs(img.astype(np.int32) - j_img.astype(np.int32))
    assert diff.max() <= 1, f"uint8 image differs by {diff.max()} LSB"


def test_fp32_fused_gn_stage2_step_matches_jax(jparams):
    fp32_stage2_against_jax(jparams, use_fused_groupnorm=True)


def fp32_stage2_against_jax(jparams, **unet_flags):
    """One fp32 stage-2 step with the UNet ``unet_flags`` on, the port on the
    CPU against JAX's train step with the same weights, batch and draws."""
    def cfg(base):
        opt = dataclasses.replace(base.train.optimizer,
                                  lr_scheduler="constant")
        return dataclasses.replace(
            base, unet=dataclasses.replace(base.unet, **unet_flags),
            edit=dataclasses.replace(base.edit, resolution=TRAIN_RES),
            train=dataclasses.replace(base.train, train_batch_size=2,
                                      mixed_precision="no", optimizer=opt))

    jcfg, tcfg = cfg(j_tiny()), cfg(tiny_test_config())
    tx = j_build_optimizer(jcfg.train.optimizer, 10, 2)
    state = JTrainState.create(jparams["unet"], tx)
    batch, rng = _batch(0, jcfg), jax.random.PRNGKey(5)
    _, j_metrics = jax.jit(make_unet_train_step(jcfg, tx))(
        state, _frozen(jparams), batch, rng)
    trainer = _port_trainer(tcfg, jparams)
    metrics = trainer.step(batch, _draws(jcfg, rng))
    # fp32 on both sides; the JAX custom VJP and the port both differentiate
    # the plain two-pass function: tests/test_torch_port_train.py's bounds
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(j_metrics["grad_norm"]), rtol=1e-4)
