"""PyTorch port, fused GroupNorm+SiLU+conv3x3 on fp32 inputs
(``csrc/conv_fused_fp32.cu``) on the CPU.

The kernel runs only on a card (``chip_smoke.py`` phase 3h and the ``cuda``
cases of ``test_torch_port_conv_fused.py``).  Here: the fp32 weight runs the
kernel reads from the OIHW tensor, a plain emulation of its three TF32
products against float64, its grid, the wrapper's dtype and weight rule, and
the slice as a whole at tiny width: an fp32 edit with all three UNet flags
and an fp32 stage-2 step with ``use_fused_conv``, against the JAX package
with the same weights (through the bridge) and the same draws (JAX: the
Pallas kernels in interpret mode; the port on the CPU: the kernels' plain
versions).
"""

import numpy as np
import pytest
import torch

from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.utils import init_pipeline_params as j_init

from diffute_tpu_torch.ops.conv_fused import (
    FP32_CIN_CHUNK,
    FP32_MIN_CHUNKS,
    FP32_TARGET_BLOCKS,
    FP32_TILE,
    check_weight,
    conv_fp32_plan,
    gn_silu_conv3x3_reference,
    gn_silu_conv3x3_tf32_reference,
    pack_conv3x3_weight,
)

# pytest puts tests/ itself on sys.path (conftest.py, prepend import mode)
from test_torch_port_conv_fused import FLAGGED_SHAPES
from test_torch_port_fp32_gn_w8 import (_on_card, fp32_edit_against_jax,
                                        fp32_stage2_against_jax)
from port_threads import torch_threads_per_worker  # noqa: F401


def _case(b, cin, cout, hw, seed):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.standard_normal((b, cin, hw, hw)), dtype=torch.float32)
    gamma = torch.tensor(rng.normal(1.0, 0.3, cin), dtype=torch.float32)
    beta = torch.tensor(rng.normal(0.0, 0.5, cin), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((cout, cin, 3, 3)) * (9 * cin) ** -0.5,
                     dtype=torch.float32)
    bias = torch.tensor(rng.normal(0.0, 0.1, cout), dtype=torch.float32)
    return x, gamma, beta, w, bias


# ---- the weight the kernel reads

@pytest.mark.parametrize("cout,cin", [(96, 64), (320, 960), (8, 8)])
def test_kernel_reads_each_chunk_of_oihw_as_one_aligned_run(cout, cin):
    # K ordered (chunk of 8 input channels, channel, tap): one output
    # channel's slice of a chunk is 72 contiguous floats of the OIHW tensor,
    # starting at element (co * Cin + 8 * chunk) * 9, a multiple of 4 (16
    # bytes) whenever Cin % 8 == 0
    w = torch.arange(cout * cin * 9, dtype=torch.float32).reshape(cout, cin,
                                                                 3, 3)
    flat = w.reshape(-1)
    rng = np.random.RandomState(0)
    for _ in range(20):
        co, chunk = rng.randint(cout), rng.randint(cin // FP32_CIN_CHUNK)
        start = (co * cin + FP32_CIN_CHUNK * chunk) * 9
        assert start % 4 == 0
        run = flat[start:start + 9 * FP32_CIN_CHUNK].reshape(FP32_CIN_CHUNK, 9)
        # [c][3 * ky + kx] is w[co, 8 * chunk + c, ky, kx]
        for c, ky, kx in [(0, 0, 0), (3, 1, 2), (7, 2, 2), (5, 0, 1)]:
            assert run[c, 3 * ky + kx] == w[co, FP32_CIN_CHUNK * chunk + c,
                                            ky, kx]


def test_an_fp32_model_keeps_no_packed_weight():
    # the layer passes no packed weight for fp32 x: the fp32 kernel adds no
    # resident bytes (the bf16 pack stays bf16 whatever w's dtype)
    from diffute_tpu_torch.models.layers import ResnetBlock2D

    blk = ResnetBlock2D(32, 32, 64, groups=8, fused_conv=True)
    assert blk._packed_weight("conv1", blk.conv1, torch.float32) is None
    assert blk._packed_weight("conv1", blk.conv1, torch.bfloat16) is None  # cpu
    assert not blk._packed
    assert pack_conv3x3_weight(blk.conv1.weight).dtype == torch.bfloat16


# ---- the three TF32 products against float64

@pytest.mark.parametrize("b,cin,cout,hw", [(1, 64, 96, 8), (1, 256, 64, 4)])
def test_three_tf32_products_are_as_close_to_fp64_as_fp32(b, cin, cout, hw):
    x, gamma, beta, w, bias = _case(b, cin, cout, hw, seed=cin)
    # GroupNorm, SiLU and the convolution in float64 (the plain version
    # computes in fp32 whatever its inputs)
    xd = x.double().reshape(b, 32, -1)
    mu = xd.mean(dim=2, keepdim=True)
    var = (xd - mu).square().mean(dim=2, keepdim=True)
    n = ((xd - mu) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
    n = n * gamma.double().view(1, -1, 1, 1) + beta.double().view(1, -1, 1, 1)
    ref64 = torch.nn.functional.conv2d(n * torch.sigmoid(n), w.double(),
                                       bias.double(), padding=1)

    def rel(y):
        return ((y.double() - ref64).norm() / ref64.norm()).item()

    # n and w each split into TF32 hi and lo, three products: about 1e-7
    # from fp64, as the plain fp32 version, far inside the kernel's 1e-5
    # contract; one product (TF32 alone) about 4e-4, far outside it
    three = gn_silu_conv3x3_tf32_reference(x, gamma, beta, w, bias, 32, 1e-5)
    plain = gn_silu_conv3x3_reference(x, gamma, beta, w, bias, 32, 1e-5)
    assert three.dtype == torch.float32
    assert rel(three) <= 1e-6 and rel(plain) <= 1e-6
    one = gn_silu_conv3x3_tf32_reference(x, gamma, beta, w, bias, 32, 1e-5,
                                         products=1)
    assert rel(one) > 1e-5


# ---- the fp32 kernel's grid

@pytest.mark.parametrize("b,cin,cout,hw", FLAGGED_SHAPES
                         + [(1, 64, 96, 24), (2, 320, 320, 96),
                            (2, 320, 320, 128), (1, 8, 8, 8)])
def test_fp32_plan_covers_the_output_with_no_empty_split(b, cin, cout, hw):
    p = conv_fp32_plan(b, cin, cout, hw, hw)
    # 8 x 8 pixel tiles and 64-channel tiles cover the output
    assert p["pixel_tiles"] == b * -(-hw // FP32_TILE) * (hw // FP32_TILE)
    assert p["pixel_tiles"] * FP32_TILE ** 2 >= b * hw * hw
    assert p["co_tiles"] * 64 >= cout > (p["co_tiles"] - 1) * 64
    # the split of Cin's 8-channel chunks leaves none empty, takes at least
    # FP32_MIN_CHUNKS a split, and splits only a grid below the target
    splits, per, chunks = p["splits"], p["chunks_per_split"], cin // 8
    assert chunks == p["chunks"] and 1 <= splits <= chunks
    assert (splits - 1) * per < chunks <= splits * per
    assert splits == 1 or per >= FP32_MIN_CHUNKS
    assert splits == 1 or p["blocks"] <= FP32_TARGET_BLOCKS
    assert p["blocks"] == p["pixel_tiles"] * p["co_tiles"] * splits
    if p["pixel_tiles"] * p["co_tiles"] >= FP32_TARGET_BLOCKS:
        assert splits == 1


def test_fp32_plan_splits_the_small_grids():
    # 8^2 x Cout 1280: 20 blocks of 64 x 64 alone; the split fills the card
    assert conv_fp32_plan(1, 1280, 1280, 8, 8)["blocks"] >= 240
    assert conv_fp32_plan(1, 320, 320, 64, 64)["splits"] == 1


# ---- the wrapper's rule

def test_fp32_x_takes_the_oihw_fp32_weight_and_no_packed_one():
    x = _on_card(torch.zeros((1, 64, 8, 8)))
    w = _on_card(torch.zeros((96, 64, 3, 3)))
    assert check_weight(x, w, None) is w
    with pytest.raises(ValueError, match="pass no packed"):
        check_weight(x, w, _on_card(torch.zeros(1)))
    with pytest.raises(ValueError, match="contiguous fp32"):
        check_weight(x, _on_card(torch.zeros((96, 64, 3, 3),
                                             dtype=torch.bfloat16)), None)
    # Cin % 8 on fp32 (a bf16 x takes Cin % 16), W % 8
    with pytest.raises(ValueError, match="Cin % 8"):
        check_weight(_on_card(torch.zeros((1, 36, 8, 8))),
                     _on_card(torch.zeros((8, 36, 3, 3))), None)
    with pytest.raises(ValueError, match="Cin % 16"):
        check_weight(_on_card(torch.zeros((1, 40, 8, 8), dtype=torch.bfloat16)),
                     _on_card(torch.zeros((8, 40, 3, 3))), None)
    with pytest.raises(ValueError, match="W % 8"):
        check_weight(_on_card(torch.zeros((1, 64, 8, 12))), w, None)
    with pytest.raises(ValueError, match=r"\(96, 64, 3, 3\)"):
        check_weight(x, _on_card(torch.zeros((96, 64, 1, 1))), None)


# ---- the slice at tiny width against the JAX package

@pytest.fixture(scope="module")
def jparams():
    return j_init(j_tiny(), seed=3)


def test_fp32_all_flags_edit_matches_jax(jparams):
    fp32_edit_against_jax(jparams, dict(use_fused_groupnorm=True,
                                        use_fused_conv=True,
                                        use_int8_weights=True))


def test_fp32_fused_conv_stage2_step_matches_jax(jparams):
    fp32_stage2_against_jax(jparams, use_fused_conv=True)
