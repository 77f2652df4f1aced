"""PyTorch port, fused GroupNorm+SiLU+conv3x3: the plain version (what a CPU
tensor gets) against the JAX op with its Pallas kernel in interpret mode
(tests/test_conv_fused.py's way), and its gradient against ``jax.grad``.

Inputs come from a numpy seed and go to both sides; the port takes NCHW x
and OIHW w, the JAX op NHWC and HWIO, so the comparison transposes.  The CUDA
kernel is compared with the plain version on a card (``cuda`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffute_tpu.ops.conv_fused as j_cf
from diffute_tpu.ops.conv_fused import gn_silu_conv3x3 as j_gn_silu_conv3x3

from diffute_tpu_torch.ops.conv_fused import (
    MAX_TILES,
    _GnSiluConvFn,
    conv_plan,
    gn_silu_conv3x3,
    gn_silu_conv3x3_reference,
    gn_silu_conv3x3_tf32_reference,
    pack_conv3x3_weight,
)
from port_threads import torch_threads_per_worker  # noqa: F401

# every GN+SiLU+conv3x3 of a flagged 512^2 UNet pass (B, Cin, Cout, H = W),
# then a 768^2 and a 1024^2 edit's top levels and one at batch 2
FLAGGED_SHAPES = [(1, 320, 320, 64), (1, 640, 320, 64), (1, 960, 320, 64),
                  (1, 320, 640, 32), (1, 640, 640, 32), (1, 960, 640, 32),
                  (1, 1280, 640, 32), (1, 1920, 640, 32),
                  (1, 640, 1280, 16), (1, 1280, 1280, 16),
                  (1, 1920, 1280, 16), (1, 2560, 1280, 16),
                  (1, 1280, 1280, 8), (1, 2560, 1280, 8),
                  (2, 640, 640, 32), (1, 320, 320, 96), (1, 320, 320, 128),
                  (1, 960, 320, 128)]


def _case(b, h, w, c, cout, seed=0, beta_std=0.1):
    """tests/test_conv_fused.py's case: NHWC x, HWIO kernel."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    s = rng.normal(1.0, 0.1, size=(c,)).astype(np.float32)
    bi = rng.normal(0.0, beta_std, size=(c,)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, c, cout)) / np.sqrt(9 * c)).astype(np.float32)
    cb = rng.normal(0.0, 0.1, size=(cout,)).astype(np.float32)
    return x, s, bi, wk, cb


def _port_args(x, s, bi, wk, cb):
    """NHWC / HWIO numpy -> the port's NCHW / OIHW tensors."""
    return (torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
            torch.tensor(s), torch.tensor(bi),
            torch.tensor(np.ascontiguousarray(wk.transpose(3, 2, 0, 1))),
            torch.tensor(cb))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 8, 16, 4),    # expanding
    (1, 8, 8, 16, 8, 4),    # contracting
    (1, 4, 4, 8, 8, 8),     # one channel per group
    (1, 6, 10, 12, 20, 3),  # nothing a power of two, H != W
])
def test_plain_matches_jax_pallas_interpret(shape):
    b, h, w, c, cout, groups = shape
    case = _case(b, h, w, c, cout)
    ref = np.asarray(j_cf._fwd_impl(*map(jnp.asarray, case), groups, 1e-5))
    launches = gn_silu_conv3x3.launches
    out = gn_silu_conv3x3(*_port_args(*case), groups, 1e-5)
    # fp32 on both sides, other summation order (tests/test_conv_fused.py)
    np.testing.assert_allclose(_nhwc(out), ref, rtol=2e-4, atol=2e-4)
    assert gn_silu_conv3x3.launches == launches  # CPU: no kernel launch


def test_border_is_zero_padding_of_the_normalised_tensor():
    # a large GroupNorm bias makes silu(d_c) far from 0: padding x with zeros
    # BEFORE the affine would then change every border pixel
    b, h, w, c, cout, groups = 1, 5, 5, 8, 8, 4
    case = _case(b, h, w, c, cout, seed=1, beta_std=2.0)
    ref = np.asarray(j_cf._fwd_impl(*map(jnp.asarray, case), groups, 1e-5))
    out = _nhwc(gn_silu_conv3x3(*_port_args(*case), groups, 1e-5))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    # the wrong order, in plain torch, is far outside that tolerance
    x, s, bi, wk, cb = _port_args(*case)
    xg = x.reshape(b, groups, -1)
    mean, var = xg.mean(-1), xg.var(-1, unbiased=False)
    a = s * torch.rsqrt(var + 1e-5).repeat_interleave(c // groups, 1)[0]
    d = bi - mean.repeat_interleave(c // groups, 1)[0] * a
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    wrong = torch.nn.functional.conv2d(torch.nn.functional.silu(
        xp * a[None, :, None, None] + d[None, :, None, None]), wk, cb)
    err = np.abs(_nhwc(wrong) - ref)
    assert err[0, 1:-1, 1:-1].max() <= 2e-4  # the interior agrees
    assert err.max() > 0.1                   # the border does not


def test_cout_tiled_shape_matches_jax():
    # the JAX kernel tiles Cout here (tests/test_conv_fused.py); the port's
    # plain version has no such gate and computes the same numbers
    b, h, w, c, cout, groups = 1, 4, 4, 8, 256, 4
    case = _case(b, h, w, c, cout)
    old = j_cf._WTILE_LIMIT
    try:
        j_cf._WTILE_LIMIT = 9 * c * 128 * 4
        assert j_cf._cout_tile(c, cout, 4) == 128
        ref = np.asarray(j_cf._fwd_impl(*map(jnp.asarray, case), groups, 1e-5))
    finally:
        j_cf._WTILE_LIMIT = old
    out = gn_silu_conv3x3(*_port_args(*case), groups, 1e-5)
    np.testing.assert_allclose(_nhwc(out), ref, rtol=2e-4, atol=2e-4)


def test_gradient_matches_jax_grad():
    b, h, w, c, cout, groups = 1, 4, 4, 8, 8, 4
    case = _case(b, h, w, c, cout, seed=2)

    def j_loss(x, s, bi, wk, cb):
        return jnp.sum(j_gn_silu_conv3x3(x, s, bi, wk, cb, groups) ** 2)

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, case))
    leaves = [t.requires_grad_() for t in _port_args(*case)]
    (gn_silu_conv3x3(*leaves, groups, 1e-5) ** 2).sum().backward()
    refs = [np.asarray(j_grads[0]).transpose(0, 3, 1, 2), j_grads[1],
            j_grads[2], np.asarray(j_grads[3]).transpose(3, 2, 0, 1),
            j_grads[4]]
    for leaf, ref in zip(leaves, refs):
        # fp32; the JAX custom VJP differentiates its plain reference
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   rtol=5e-4, atol=5e-4)


def test_autograd_function_backward_is_the_plain_versions():
    # the CUDA path's autograd node, driven here with CPU tensors
    case = _case(1, 4, 4, 8, 8, seed=3)
    g = torch.tensor(np.random.default_rng(4).normal(
        size=(1, 8, 4, 4)).astype(np.float32))
    a = [t.requires_grad_() for t in _port_args(*case)]
    b = [t.detach().clone().requires_grad_() for t in a]
    _GnSiluConvFn.apply(*a, None, 4, 1e-5).backward(g)
    gn_silu_conv3x3_reference(*b, 4, 1e-5).backward(g)
    for ta, tb in zip(a, b):
        assert torch.equal(ta.grad, tb.grad)


def test_packed_weight_layout():
    # (Cout, Cin, 3, 3) -> (Cin chunks of 16, ky, Cout tiles of 64, kx, 16
    # input channels, 64 output channels), 16-byte chunk j of a row at
    # j ^ (input channel % 8): the kernel's A operand as shared memory holds it
    rng = np.random.default_rng(5)
    w = torch.tensor(rng.normal(size=(130, 32, 3, 3)).astype(np.float32))
    packed = pack_conv3x3_weight(w, torch.float32)
    assert packed.shape == (2, 3, 3, 3, 16, 64) and packed.is_contiguous()
    for co, ci, ky, kx in [(0, 0, 0, 0), (5, 17, 1, 2), (129, 31, 2, 0),
                           (127, 16, 2, 2), (70, 9, 0, 1)]:
        i, o = ci % 16, co % 64
        assert packed[ci // 16, ky, co // 64, kx, i,
                      ((o // 8) ^ (i % 8)) * 8 + o % 8] == w[co, ci, ky, kx]
    # zero past Cout: tile 2 holds channels 128 and 129 only
    real = torch.zeros(16, 64, dtype=torch.bool)
    for i in range(16):
        for o in (0, 1):
            real[i, ((o // 8) ^ (i % 8)) * 8 + o % 8] = True
    assert not packed[:, :, 2][..., ~real].any()
    assert packed.double().abs().sum() == w.double().abs().sum()
    assert pack_conv3x3_weight(w).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        pack_conv3x3_weight(torch.zeros(2, 16, 1, 1))
    with pytest.raises(ValueError):
        pack_conv3x3_weight(torch.zeros(2, 3, 3, 3))  # Cin % 16


@pytest.mark.parametrize("b,cin,cout,hw", FLAGGED_SHAPES + [(1, 64, 96, 24)])
def test_plan_covers_the_output_with_no_empty_split(b, cin, cout, hw):
    plan = conv_plan(b, cin, cout, hw, hw)
    # 64-pixel tiles of whole rows' columns cover the image
    assert plan["tile_w"] * plan["tile_rows"] == 64 and hw % plan["tile_w"] == 0
    assert plan["pixel_tiles"] * 64 >= b * hw * hw
    assert plan["pixel_tiles"] == b * -(-hw // plan["tile_rows"]) * (
        hw // plan["tile_w"])
    # every Cout tile of 64 is owned by exactly one block, none empty, and a
    # block normalises each chunk for at least 256 channels (all of Cout
    # below that)
    tiles, blocks = plan["tiles_per_block"], plan["co_blocks"]
    assert plan["m_tiles"] == -(-cout // 64) and 1 <= tiles <= MAX_TILES
    assert (blocks - 1) * tiles < plan["m_tiles"] <= blocks * tiles
    assert tiles * 64 >= min(cout, 256)
    # the split of Cin's 16-channel chunks leaves none empty
    splits, chunks = plan["splits"], cin // 16
    per = -(-chunks // splits)
    assert 1 <= splits <= chunks and (splits - 1) * per < chunks
    assert plan["blocks"] == plan["pixel_tiles"] * blocks * splits


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 32, 8, 8), device="meta")
    v = torch.zeros(32, device="meta")
    w = torch.zeros((32, 32, 3, 3), device="meta")
    with pytest.raises(ValueError):  # neither cuda nor cpu: no fallback
        gn_silu_conv3x3(x, v, v, w, v, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cout,hw", [(1, 320, 320, 64), (1, 960, 320, 64),
                                           (1, 1920, 640, 32),
                                           (1, 2560, 1280, 16),
                                           (1, 1280, 1280, 8),
                                           (2, 640, 640, 32), (1, 320, 320, 96),
                                           (1, 64, 96, 24)])
def test_cuda_kernel_matches_plain(b, cin, cout, hw):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, mean=0.0, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std
                + mean).bfloat16()

    x = randn(b, cin, hw, hw)
    gamma, beta = randn(cin, mean=1.0, std=0.3), randn(cin, std=0.5)
    w, bias = randn(cout, cin, 3, 3, std=(9 * cin) ** -0.5), randn(cout, std=0.1)
    packed = pack_conv3x3_weight(w)
    before = gn_silu_conv3x3.launches
    y = gn_silu_conv3x3(x, gamma, beta, w, bias, 32, 1e-5, packed=packed)
    again = gn_silu_conv3x3(x, gamma, beta, w, bias, 32, 1e-5, packed=packed)
    torch.cuda.synchronize()
    assert gn_silu_conv3x3.launches == before + 2
    assert torch.equal(y, again)  # deterministic: split sums in fixed order
    ref = gn_silu_conv3x3_reference(x, gamma, beta, w, bias, 32, 1e-5).float()
    # one fp32 result rounded to bf16 on both sides: 3 half-ulps of max |ref|
    # and a relative L2 error of 2e-3 (a dropped tap gives 0.3)
    diff = y.float() - ref
    assert diff.abs().max().item() <= 3 * ref.abs().max().item() * 2 ** -8
    assert (diff.norm() / ref.norm()).item() <= 2e-3
    # the output scaled by 0.99 fails the same criterion
    assert ((y.float() * 0.99 - ref).norm() / ref.norm()).item() > 2e-3
    with pytest.raises(ValueError):
        gn_silu_conv3x3(x.float(), gamma, beta, w, bias, 32, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cout,hw", [(1, 320, 320, 64), (1, 1920, 640, 32),
                                           (1, 2560, 1280, 16),
                                           (1, 1280, 1280, 8),
                                           (2, 640, 640, 32), (1, 64, 96, 24)])
def test_cuda_fp32_kernel_matches_plain(b, cin, cout, hw):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, mean=0.0, std=1.0):
        return torch.randn(shape, generator=g, device="cuda") * std + mean

    x = randn(b, cin, hw, hw)
    gamma, beta = randn(cin, mean=1.0, std=0.3), randn(cin, std=0.5)
    w, bias = randn(cout, cin, 3, 3, std=(9 * cin) ** -0.5), randn(cout, std=0.1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version in fp32
    try:
        before = gn_silu_conv3x3.launches
        y = gn_silu_conv3x3(x, gamma, beta, w, bias, 32, 1e-5)
        again = gn_silu_conv3x3(x, gamma, beta, w, bias, 32, 1e-5)
        torch.cuda.synchronize()
        assert gn_silu_conv3x3.launches == before + 2
        assert y.dtype == torch.float32 and torch.equal(y, again)
        ref = gn_silu_conv3x3_reference(x, gamma, beta, w, bias, 32, 1e-5)
        one = gn_silu_conv3x3_tf32_reference(x, gamma, beta, w, bias, 32,
                                             1e-5, products=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    def rel(a):
        return ((a.double() - ref.double()).norm() / ref.double().norm()).item()

    # 3xTF32 products, fp32 sums: relative L2 1e-5 of the plain fp32
    # version; TF32 alone (one product) fails it
    assert rel(y) <= 1e-5
    assert rel(one) > 1e-5
    with pytest.raises(ValueError):  # the fp32 kernel takes no packed weight
        gn_silu_conv3x3(x, gamma, beta, w, bias, 32, 1e-5,
                        packed=pack_conv3x3_weight(w))
    with pytest.raises(ValueError):  # nor fp16 x
        gn_silu_conv3x3(x.half(), gamma, beta, w, bias, 32, 1e-5)
