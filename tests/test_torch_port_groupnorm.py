"""PyTorch port, fused GroupNorm+SiLU: the plain version (what a CPU tensor
gets) against the JAX op, run as tests/test_groupnorm.py runs it (the Pallas
kernel in interpret mode), and its gradient against ``jax.grad``.

Inputs come from a numpy seed and go to both sides; the port is NCHW and the
JAX op NHWC, so the comparison transposes.  The CUDA kernels themselves are
compared with the plain version on a card (``cuda`` marker; skipped here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffute_tpu.ops.groupnorm import _xla_gn_silu
from diffute_tpu.ops.groupnorm import group_norm_silu as j_group_norm_silu

from diffute_tpu_torch.ops.groupnorm import (
    _GroupNormSiLUFn,
    gn_plan,
    group_norm_silu,
    group_norm_silu_reference,
    group_norm_stats,
    group_norm_stats_reference,
    group_norm_stats_tiled_reference,
)
from port_threads import torch_threads_per_worker  # noqa: F401


def _case(shape_nhwc, seed=0, mean=0.0):
    rng = np.random.RandomState(seed)
    c = shape_nhwc[-1]
    x = (rng.standard_normal(shape_nhwc) + mean).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _jax_pallas(x, scale, bias, groups, eps=1e-5):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(j_group_norm_silu(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups, eps,
            use_pallas=True).astype(jnp.float32))


@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 64), 4),
    ((1, 16, 16, 320), 32),  # the UNet's top width, small spatially
    ((1, 4, 4, 1280), 32),   # a deep block's width
    ((3, 6, 10, 48), 8),     # nothing a power of two
])
def test_plain_matches_jax_pallas_interpret(shape, groups):
    x, scale, bias = _case(shape)
    ref = _jax_pallas(x, scale, bias, groups)
    launches = group_norm_silu.launches
    out = group_norm_silu(_nchw(x), torch.tensor(scale), torch.tensor(bias),
                          groups, 1e-5)
    assert out.dtype == torch.float32 and out.shape == _nchw(x).shape
    # fp32 on both sides; the Pallas kernel takes var = E[x^2] - mean^2 and
    # folds the affine, so sums and products run in another order: 1e-4
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-4, rtol=1e-4)
    assert group_norm_silu.launches == launches  # CPU: no kernel launch


def test_large_mean_input_keeps_the_two_pass_accuracy():
    # |mean| >> std: E[x^2] - mean^2 cancels in fp32; the port subtracts the
    # mean first, like the JAX package's plain reference
    x, scale, bias = _case((1, 8, 8, 64), seed=1, mean=300.0)
    out = _nhwc(group_norm_silu(_nchw(x), torch.tensor(scale),
                                torch.tensor(bias), 4, 1e-5))
    ref = np.asarray(_xla_gn_silu(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), 4, 1e-5))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    # and against float64 numpy: x itself carries 3e-5 of rounding at 300,
    # so the result is exact to 1e-4 only if the variance did not cancel
    xd = x.astype(np.float64).reshape(1, 64, 4, 16)
    mu = xd.mean(axis=(1, 3), keepdims=True)
    var = ((xd - mu) ** 2).mean(axis=(1, 3), keepdims=True)
    y = ((xd - mu) / np.sqrt(var + 1e-5)).reshape(x.shape) * scale + bias
    np.testing.assert_allclose(out, y / (1 + np.exp(-y)), atol=1e-4)
    mean, rstd = group_norm_stats(_nchw(x), 4, 1e-5)
    np.testing.assert_allclose(mean.numpy()[0], mu.ravel(), rtol=1e-6)
    np.testing.assert_allclose(rstd.numpy()[0], 1 / np.sqrt(var.ravel() + 1e-5),
                               rtol=1e-4)


def test_bf16_matches_jax_bf16():
    x, scale, bias = _case((1, 8, 8, 64), seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    sb, bb = jnp.asarray(scale, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16)
    ref = _jax_pallas(xb, sb, bb, 4)
    to_t = lambda a: torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()
    out = group_norm_silu(to_t(xb).permute(0, 3, 1, 2).contiguous(), to_t(sb),
                          to_t(bb), 4, 1e-5)
    assert out.dtype == torch.bfloat16
    # both round an fp32 result once to bf16: they differ by at most one bf16
    # ulp of the output (2^-7 relative; values reach ~4)
    np.testing.assert_allclose(_nhwc(out), ref, atol=2 ** -7 * 4, rtol=0)


def test_stats_reference_is_mean_and_rstd_per_sample_and_group():
    x, _, _ = _case((2, 4, 4, 32), seed=3)
    mean, rstd = group_norm_stats_reference(_nchw(x), 8, 1e-5)
    xg = x.reshape(2, 16, 8, 4)
    np.testing.assert_allclose(mean.numpy(), xg.mean(axis=(1, 3)), atol=1e-6)
    np.testing.assert_allclose(
        rstd.numpy(), 1 / np.sqrt(xg.var(axis=(1, 3)) + 1e-5), rtol=1e-5)


def test_gradient_matches_jax_grad():
    x, scale, bias = _case((2, 4, 4, 32), seed=4)
    w = np.random.RandomState(5).standard_normal(x.shape).astype(np.float32)

    def j_loss(x, s, b):
        return jnp.sum(j_group_norm_silu(x, s, b, 8, 1e-5) * jnp.asarray(w))

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [_nchw(x).requires_grad_(), torch.tensor(scale, requires_grad=True),
              torch.tensor(bias, requires_grad=True)]
    (group_norm_silu(*leaves, 8, 1e-5) * _nchw(w)).sum().backward()
    # fp32, the JAX custom VJP differentiates its plain reference: 5e-4
    np.testing.assert_allclose(_nhwc(leaves[0].grad), np.asarray(j_grads[0]),
                               atol=5e-4, rtol=5e-4)
    for leaf, ref in zip(leaves[1:], j_grads[1:]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   atol=5e-4, rtol=5e-4)


def test_autograd_function_backward_is_the_plain_versions():
    # the CUDA path's autograd node, driven here with CPU tensors
    x, scale, bias = _case((1, 4, 4, 16), seed=6)
    g = torch.tensor(np.random.RandomState(7).standard_normal(
        (1, 16, 4, 4)).astype(np.float32))
    a = [_nchw(x).requires_grad_(), torch.tensor(scale, requires_grad=True),
         torch.tensor(bias, requires_grad=True)]
    b = [t.detach().clone().requires_grad_() for t in a]
    _GroupNormSiLUFn.apply(*a, 4, 1e-5).backward(g)
    group_norm_silu_reference(*b, 4, 1e-5).backward(g)
    for ta, tb in zip(a, b):
        assert torch.equal(ta.grad, tb.grad)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 32, 8, 8), device="meta")
    w = torch.zeros(32, device="meta")
    with pytest.raises(ValueError):  # neither cuda nor cpu: no fallback
        group_norm_silu(x, w, w, 32)
    with pytest.raises(ValueError):
        group_norm_stats(x, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,mean", [((1, 320, 64, 64), 0.0),
                                        ((1, 2560, 8, 8), 0.0),
                                        ((2, 640, 32, 32), 0.0),
                                        ((1, 320, 64, 64), 100.0),
                                        # beyond a cluster's shared memory
                                        ((1, 128, 512, 512), 0.0)])
def test_cuda_kernels_match_plain(shape, mean, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(shape, generator=g, device="cuda") + mean).to(dtype)
    gamma = 1 + 0.3 * torch.randn(shape[1], generator=g, device="cuda")
    beta = 0.5 * torch.randn(shape[1], generator=g, device="cuda")
    gamma, beta = gamma.to(dtype), beta.to(dtype)
    # GN+SiLU is one launch at every shape, the statistics one more
    before = group_norm_silu.launches, group_norm_stats.launches
    y = group_norm_silu(x, gamma, beta, 32, 1e-5)
    torch.cuda.synchronize()
    assert y.dtype == dtype
    assert (group_norm_silu.launches, group_norm_stats.launches) == (
        before[0] + 1, before[1])
    assert gn_plan(*shape, 32, x.element_size())["one_read"] == (
        shape[1:] != (128, 512, 512))
    ref = group_norm_silu_reference(x, gamma, beta, 32, 1e-5).float()
    diff = y.float() - ref
    if dtype == torch.bfloat16:
        # one fp32 result rounded to bf16 on both sides: 3 half-ulps of
        # max |ref| and a relative L2 error of 2e-3
        assert diff.abs().max().item() <= 3 * ref.abs().max().item() * 2 ** -8
        assert (diff.norm() / ref.norm()).item() <= 2e-3
    else:
        # the fp32 contract: relative L2 1e-5; the output rounded through
        # bf16 must fail it
        assert (diff.norm() / ref.norm()).item() <= 1e-5
        rounded = ref.bfloat16().float() - ref
        assert (rounded.norm() / ref.norm()).item() > 1e-5
    mean_k, rstd_k = group_norm_stats(x, 32, 1e-5)
    assert group_norm_stats.launches == before[1] + 1
    mean_r, rstd_r = group_norm_stats_reference(x, 32, 1e-5)
    assert (mean_k - mean_r).abs().max().item() <= 1e-5 * max(1.0, abs(mean))
    assert ((rstd_k - rstd_r).abs() / rstd_r).max().item() <= 1e-4
    if dtype == torch.float32:
        # the same merge as the tiled plain version at the fp32 plan: 1e-6
        mean_t, rstd_t = group_norm_stats_tiled_reference(x, 32, 1e-5)
        assert ((mean_k - mean_t).abs().max().item()
                <= 1e-6 * max(1.0, abs(mean)))
        assert ((rstd_k - rstd_t).abs() / rstd_t).max().item() <= 1e-6
    # the merge has a fixed order: the same bits on every run
    assert torch.equal(group_norm_silu(x, gamma, beta, 32, 1e-5), y)
    again = group_norm_stats(x, 32, 1e-5)
    assert torch.equal(again[0], mean_k) and torch.equal(again[1], rstd_k)
    for other in (torch.float16, torch.float64):  # no fallback
        with pytest.raises(ValueError):
            group_norm_silu(x.to(other), gamma, beta, 32, 1e-5)
        with pytest.raises(ValueError):
            group_norm_stats(x.to(other), 32, 1e-5)
