"""PyTorch port, attention ops: the flash kernel's plain version, the dense
path and the dispatch gate against the JAX package, plus the nearest resize.

The JAX flash forward runs as tests/test_flash_attention.py runs it on the
CPU (Pallas interpret mode).  The CUDA kernel itself runs only on a card:
its test is marked ``cuda`` and skips elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffute_tpu.ops.flash_attention as jfa
from diffute_tpu.ops.attention import _xla_attention
from diffute_tpu.ops.attention import dot_product_attention as j_dpa
from diffute_tpu.ops.interpolate import nearest_resize_2d as j_nearest

import diffute_tpu_torch.ops.attention as tattn
from diffute_tpu_torch.ops import (
    dense_attention,
    dot_product_attention,
    flash_attention,
    flash_attention_reference,
    nearest_resize_2d,
)
from diffute_tpu_torch.ops.flash_attention import _to3d, flash_fwd_3d


def _qkv(seed, b, s, t, h, d):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, h, d)).astype(np.float32),
            rng.standard_normal((b, t, h, d)).astype(np.float32))


# fp32 on both sides; the two differ only in summation order (the Pallas
# kernel sums per kv block with an online rescale), so 2e-5 on outputs of
# unit scale and 1e-5 on the LSE leave ~10x headroom over what was seen.
ATOL_O, ATOL_LSE = 2e-5, 1e-5


@pytest.mark.parametrize("s,t", [(256, 256), (300, 577)])
def test_plain_flash_matches_jax_flash(s, t):
    q, k, v = _qkv(0, 2, s, t, 2, 64)
    scale = 64 ** -0.5
    j_out, (_, _, _, _, j_lse) = jfa._flash_fwd_rule(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o3, lse = flash_attention_reference(_to3d(tq), _to3d(tk), _to3d(tv), scale)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=ATOL_LSE, rtol=0)
    out = flash_attention(tq, tk, tv)  # CPU tensors: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL_O,
                               rtol=0)
    assert torch.equal(out, o3.reshape(2, 2, s, 64).permute(0, 2, 1, 3))


@pytest.mark.parametrize("s,t", [(256, 256), (300, 577)])
def test_dense_matches_xla_attention(s, t):
    q, k, v = _qkv(1, 1, s, t, 3, 16)
    scale = 16 ** -0.5
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), scale))
    out = dense_attention(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL_O, rtol=0)


@pytest.mark.parametrize("t", [577, 1023, 1024, 1100])
@pytest.mark.parametrize("use_flash", [False, True])
def test_dispatch_gate_matches_jax(monkeypatch, t, use_flash):
    """The flash entry is reached exactly when use_flash and T >= 1024, on
    both sides, and the result is the same either way."""
    calls = {"jax": 0, "torch": 0}

    def spy(side, fn):
        def wrapped(*a, **kw):
            calls[side] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jfa, "flash_attention", spy("jax", jfa.flash_attention))
    monkeypatch.setattr(tattn, "flash_attention", spy("torch", flash_attention))
    q, k, v = _qkv(2, 1, 8, t, 1, 64)
    j_out = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  use_flash=use_flash)
    out = dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                use_flash=use_flash)
    expect = int(use_flash and t >= 1024)
    assert calls == {"jax": expect, "torch": expect}
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL_O,
                               rtol=0)


@pytest.mark.parametrize("shape,out_hw", [((2, 64, 48), (8, 6)),
                                          ((1, 512, 512), (64, 64)),
                                          ((1, 37, 53, 3), (11, 7))])
def test_nearest_resize_matches_jax(shape, out_hw):
    x = np.random.RandomState(3).randint(0, 2, shape).astype(np.float32)
    ref = np.asarray(j_nearest(jnp.asarray(x), *out_hw))
    out = nearest_resize_2d(torch.from_numpy(x), *out_hw)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    # CPU tensors never reach the kernel; the checks guard CUDA inputs, and
    # an unsupported device must raise rather than compute something else
    q = torch.zeros((1, 4, 64), device="meta")
    with pytest.raises(ValueError):
        flash_fwd_3d(q, q, q, 0.125)
    launches = flash_attention.launches
    flash_fwd_3d(*(torch.zeros((1, 4, 64)) for _ in range(3)), 0.125)
    assert flash_attention.launches == launches  # CPU: no kernel launch


@pytest.mark.parametrize("b", [1, 2])
def test_3d_layout_is_contiguous_for_the_kernel(b):
    # what the UNet hands the wrapper: a (B, S, H*D) projection viewed as heads
    x = torch.randn(b, 32, 5 * 64).view(b, 32, 5, 64)
    x3 = _to3d(x)
    assert x3.shape == (b * 5, 32, 64) and x3.is_contiguous()
    assert torch.equal(x3.reshape(b, 5, 32, 64).permute(0, 2, 1, 3), x)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t", [(5, 4096, 4096), (10, 1024, 1024),
                                    (3, 1000, 577)])
def test_cuda_kernel_matches_plain(bh, s, t):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((bh, n, 64), generator=g, device="cuda",
                           dtype=torch.bfloat16) for n in (s, t, t))
    before = flash_attention.launches
    o, lse = flash_fwd_3d(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ro, rlse = flash_attention_reference(q, k, v, 0.125)
    # bf16 output rounding of unit-scale values: 2e-2; fp32 LSE: 1e-3
    assert (o.float() - ro.float()).abs().max().item() <= 2e-2
    assert (lse - rlse).abs().max().item() <= 1e-3
    with pytest.raises(ValueError):
        flash_fwd_3d(q.float(), k.float(), v.float(), 0.125)  # no fallback
