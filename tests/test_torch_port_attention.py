"""PyTorch port, attention ops: the flash kernel's plain version, the dense
path and the dispatch gate against the JAX package, plus the nearest resize.

The JAX flash forward runs as tests/test_flash_attention.py runs it on the
CPU (Pallas interpret mode).  The CUDA kernel itself runs only on a card:
its test is marked ``cuda`` and skips elsewhere.
"""

import importlib

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

tfa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")


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


@pytest.mark.parametrize("s,t", [(256, 256), (300, 577), (64, 1000)])
def test_tiled_plain_version_matches_jax_flash(s, t):
    """The kernels' tile-by-tile plain version (ragged last tile included)
    computes the JAX flash forward's function."""
    q, k, v = _qkv(5, 2, s, t, 2, 64)
    j_out, (_, _, _, _, j_lse) = jfa._flash_fwd_rule(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None)
    o3, lse = tfa.flash_fwd_tiled_reference(
        *(_to3d(torch.from_numpy(x)) for x in (q, k, v)), 64 ** -0.5)
    # fp32 on both sides, other tiles and another order of the rescales:
    # tests/test_flash_attention.py's bounds
    np.testing.assert_allclose(o3.reshape(2, 2, s, 64).permute(0, 2, 1, 3),
                               np.asarray(j_out), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=ATOL_LSE, rtol=0)


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


@pytest.mark.parametrize("s,t", [(256, 256), (300, 577)])
def test_serving_flash_reads_4d_views_without_copies(monkeypatch, s, t):
    """No-grad flash_attention on (B, S, H, 64) tensors (the serving path)
    makes no _to3d copy, returns o contiguous, so the caller's reshape to
    (B, S, H*D) is a view, and equals the _to3d route and the JAX flash."""
    q, k, v = _qkv(0, 2, s, t, 2, 64)
    j_out, _ = jfa._flash_fwd_rule(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), None, None, None)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o3, _ = flash_attention_reference(_to3d(tq), _to3d(tk), _to3d(tv),
                                      64 ** -0.5)
    via_3d = o3.reshape(2, 2, s, 64).permute(0, 2, 1, 3)

    def no_copy(x):
        raise AssertionError("the serving branch copied its input")

    monkeypatch.setattr(tfa, "_to3d", no_copy)
    with torch.no_grad():
        out = flash_attention(tq, tk, tv)
    assert out.shape == (2, s, 2, 64) and out.is_contiguous()
    assert out.reshape(2, s, 128).data_ptr() == out.data_ptr()
    np.testing.assert_allclose(out.numpy(), via_3d.numpy(), atol=ATOL_O,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL_O,
                               rtol=0)


def test_flash_fwd_takes_views_of_a_packed_projection():
    # q, k, v as strided (B, S, H, 64) views of one (B, S, 3, H, 64) array
    x = np.random.RandomState(4).standard_normal(
        (2, 256, 3, 2, 64)).astype(np.float32)
    q4, k4, v4 = (torch.from_numpy(x)[:, :, i] for i in range(3))
    assert not q4.is_contiguous()
    o, lse = tfa.flash_fwd(q4, k4, v4, 0.125)
    ro, rlse = flash_attention_reference(_to3d(q4), _to3d(k4), _to3d(v4),
                                         0.125)
    assert o.is_contiguous() and lse.shape == (4, 256)
    np.testing.assert_allclose(_to3d(o).numpy(), ro.numpy(), atol=ATOL_O,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), atol=ATOL_LSE,
                               rtol=0)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,match", [
    # (B, S, H, 64) with head_dim not the innermost axis
    (lambda: _bf16(2, 64, 8, 2).permute(0, 3, 2, 1), "last stride"),
    # rows of 68 elements: a stride of 136 bytes is not a multiple of 16
    (lambda: _bf16(2, 8, 2, 68)[..., :64], "multiples of 8"),
    # a base 2 bytes past an aligned allocation
    (lambda: _bf16(2 * 8 * 2 * 64 + 8)[1:2049].view(2, 8, 2, 64),
     "16-byte aligned")])
def test_tma_layout_check_raises(make, match):
    with pytest.raises(ValueError, match=match):
        tfa.check_tma_layout(make(), "q")


def test_tma_layout_check_takes_what_tma_reads():
    tfa.check_tma_layout(_bf16(2, 8, 3, 2, 64)[:, :, 1], "q")  # packed view
    tfa.check_tma_layout(_bf16(4, 8, 64)[:, :, None], "q")     # 3-D as H = 1


def _cuda_qkv(g, bh, s, t, strided):
    """(BH, S|T, 64) tensors, or (1, S, BH, 64) views of one packed
    (1, S, 3, BH, 64) projection (S == T)."""
    if strided:
        x = torch.randn((1, s, 3, bh, 64), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]
    return tuple(torch.randn((bh, n, 64), generator=g, device="cuda",
                             dtype=torch.bfloat16) for n in (s, t, t))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t,strided", [
    (5, 4096, 4096, False), (10, 1024, 1024, False), (3, 1000, 577, False),
    (5, 16384, 16384, False), (5, 4096, 4096, True), (10, 1024, 1024, True)])
def test_cuda_kernel_matches_plain(bh, s, t, strided):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = _cuda_qkv(g, bh, s, t, strided)
    before = flash_attention.launches
    if strided:
        o, lse = tfa.flash_fwd(q, k, v, 0.125)
        assert o.is_contiguous()
        q, k, v, o = (_to3d(x) for x in (q, k, v, o))
    else:
        o, lse = flash_fwd_3d(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ro, rlse = tfa.flash_fwd_tiled_reference(q, k, v, 0.125)
    # o is an fp32 result rounded once to bf16 on each side, p rounded to
    # bf16 against the same running max: 3 half-ulps of max |ref| and
    # relative L2 2e-3 (o scaled by 0.99 fails it); the LSE is fp32
    diff = o.float() - ro.float()
    assert diff.abs().max() <= 3 * ro.float().abs().max() * 2.0 ** -8
    assert diff.norm() / ro.float().norm() <= 2e-3
    assert (lse - rlse).abs().max().item() <= 1e-4
    with pytest.raises(ValueError):
        flash_fwd_3d(q.float(), k.float(), v.float(), 0.125)  # no fallback
