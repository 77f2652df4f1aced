"""PyTorch port: the deferred-softmax flash forward against the JAX package's.

The same numpy-seeded q, k, v go through the JAX ``_flash_fwd_3d_pipelined``
(the Pallas kernel in interpret mode, ``PIPELINE_FWD`` set on the JAX module
by monkeypatch) and through the port's ``flash_fwd_pipelined_reference``, the
plain step-by-step version of ``csrc/flash_fwd_pipelined.cu`` that the
wrapper computes for CPU tensors.  Gradients go through ``FlashAttentionFn``
with the port's switch on, so the backward consumes the pipelined forward's
LSE: that pins the base-2 -> natural-log conversion.  The CUDA kernel itself
is compared with its plain version on a card (``cuda`` marker; skipped here).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffute_tpu.ops import flash_attention as jfa
from diffute_tpu.ops.attention import _xla_attention
from port_threads import torch_threads_per_worker  # noqa: F401

tfa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")

LN2 = 0.6931471805599453


def _qkv(seed, bh, s, t, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal((bh, n, 64)).astype(dtype)
                 for n in (s, t, t))


def _jax_pipelined(q, k, v, scale, block_q, block_kv, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_fwd_3d_pipelined(
            jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            scale, block_q, block_kv)
    return np.asarray(o, np.float32), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("s,t,block_q,block_kv", [
    (256, 2048, 256, 512), (512, 2048, 256, 512),
    (128, 128 * 2, 128, 128), (128, 128 * 5, 128, 128)])
def test_plain_version_matches_jax_kernel_fp32(s, t, block_q, block_kv):
    q, k, v = _qkv(0, 2, s, t)
    jo, jlse = _jax_pipelined(q, k, v, 0.125, block_q, block_kv)
    o, lse = tfa.flash_fwd_pipelined_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), 0.125)
    # fp32 on both sides, another tile size and q pre-scaled there, scores
    # scaled here: tests/test_flash_attention.py's bounds
    np.testing.assert_allclose(o.numpy(), jo, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5, rtol=0)


def test_plain_version_matches_jax_kernel_bf16():
    q, k, v = _qkv(1, 2, 256, 2048)
    jo, _ = _jax_pipelined(q, k, v, 0.125, 256, 512, jnp.bfloat16)
    o, _ = tfa.flash_fwd_pipelined_reference(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), 0.125)
    assert o.dtype == torch.bfloat16
    # both round o once to bf16 (and p before p v; JAX also q * scale): one
    # bf16 ulp of the largest output
    ulp = float(np.abs(jo).max()) * 2.0 ** -7
    assert float(np.abs(o.float().numpy() - jo).max()) <= ulp


def test_plain_version_is_tile_by_tile_and_agrees_with_one_pass():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 3, 100, 320))
    o, lse = tfa.flash_fwd_pipelined_reference(q, k, v, 0.3)
    ro, rlse = tfa.flash_attention_reference(q, k, v, 0.3)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), atol=1e-5, rtol=0)
    # the tile size does not change the function
    o2, lse2 = tfa.flash_fwd_pipelined_reference(q, k, v, 0.3, block_kv=160)
    np.testing.assert_allclose(o2.numpy(), o.numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse2.numpy(), lse.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("t", [128, 320])
def test_pipelined_plain_version_is_the_tiled_one(t):
    # the deferred schedule reorders the work, not the arithmetic: in bf16
    # the two plain versions agree to the bit, as the two kernels do
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(7, 2, 96, t))
    o, lse = tfa.flash_fwd_pipelined_reference(q, k, v, 0.125)
    to, tlse = tfa.flash_fwd_tiled_reference(q, k, v, 0.125)
    assert torch.equal(o, to) and torch.equal(lse, tlse)


def test_mutants_fail_the_bounds():
    # an LSE left in base 2, and a last tile never consumed, are far
    # outside the bounds the kernel is held to
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 2, 128, 512))
    o, lse = tfa.flash_fwd_pipelined_reference(q, k, v, 0.125)
    assert float((lse / LN2 - lse).abs().max()) > 1.0
    cut = tfa.PIPELINED_BLOCK_KV
    mo, mlse = tfa.flash_fwd_pipelined_reference(q, k[:, :-cut], v[:, :-cut],
                                                 0.125)
    assert float((mlse - lse).abs().max()) > 1e-2
    assert float((mo - o).norm() / o.norm()) > 1e-1


def test_gradients_through_the_pipelined_lse_match_jax(monkeypatch):
    rng = np.random.RandomState(5)
    q, k, v = (rng.standard_normal((1, n, 1, 64)).astype(np.float32)
               for n in (256, 2048, 2048))

    monkeypatch.setattr(jfa, "PIPELINE_FWD", True)

    def loss_flash(q, k, v):
        with pltpu.force_tpu_interpret_mode():
            out = jfa.flash_attention(q, k, v, None, 256, 512)
        return jnp.sum(out * jnp.cos(out))

    def loss_ref(q, k, v):
        out = _xla_attention(q, k, v, 64 ** -0.5)
        return jnp.sum(out * jnp.cos(out))

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    g_jax = jax.grad(loss_flash, argnums=(0, 1, 2))(*args)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(*args)

    monkeypatch.setattr(tfa, "PIPELINE_FWD", True)
    calls = []
    real = tfa.flash_fwd_pipelined_reference  # the switch's CPU route
    monkeypatch.setattr(tfa, "flash_fwd_pipelined_reference",
                        lambda *a: calls.append(1) or real(*a))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    (out * torch.cos(out)).sum().backward()
    assert calls == [1]  # the autograd function's forward took the switch
    for leaf, gj, gr in zip(leaves, g_jax, g_ref):
        # tests/test_flash_attention.py:172's bounds, against both
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gj),
                                   atol=5e-5, rtol=1e-3)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gr),
                                   atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("switch,t,pipelined", [
    (False, 2048, False),   # switch off
    (True, 2048, True),
    (True, 128, True),      # two tiles
    (True, 64, False),      # one tile
    (True, 577, False),     # not a multiple of the tile
    (True, 1000, False)])
def test_dispatch_rule(monkeypatch, switch, t, pipelined):
    monkeypatch.setattr(tfa, "PIPELINE_FWD", switch)
    taken = []
    for name in ("flash_fwd_pipelined_reference", "flash_attention_reference"):
        real = getattr(tfa, name)
        monkeypatch.setattr(
            tfa, name, lambda *a, _n=name, _r=real: taken.append(_n) or _r(*a))
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 64, t))
    o, lse = tfa.flash_fwd_3d(q, k, v, 0.125)
    assert o.shape == q.shape and lse.shape == (1, 64)
    assert taken == ["flash_fwd_pipelined_reference" if pipelined
                     else "flash_attention_reference"]


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 64, 577))
    with pytest.raises(ValueError, match="multiple of"):
        tfa.flash_fwd_3d_pipelined(q, k, v, 0.125)
    with pytest.raises(ValueError, match="multiple of"):
        tfa.flash_fwd_3d_pipelined(q, k[:, :64], v[:, :64], 0.125)


def test_set_pipeline_fwd_sets_the_module_switch(monkeypatch):
    monkeypatch.setattr(tfa, "PIPELINE_FWD", False)
    assert tfa.set_pipeline_fwd(True) is False and tfa.PIPELINE_FWD is True
    assert tfa.set_pipeline_fwd(False) is True and tfa.PIPELINE_FWD is False


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t,strided", [
    (5, 4096, 4096, False), (10, 2304, 2304, False), (3, 1000, 1024, False),
    (2, 64, 128, False), (5, 16384, 16384, False), (5, 4096, 4096, True),
    (20, 1024, 1024, True)])
def test_cuda_kernel_matches_plain_and_standard(monkeypatch, bh, s, t,
                                                strided):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    g = torch.Generator(device="cuda").manual_seed(0)
    if strided:  # (1, S, BH, 64) views of one packed projection, S == T
        x = torch.randn((1, s, 3, bh, 64), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    else:
        q, k, v = (torch.randn((bh, n, 64), generator=g, device="cuda",
                               dtype=torch.bfloat16) for n in (s, t, t))
    before = tfa.flash_attention.pipelined_launches
    if strided:  # through the dispatcher, as the serving path calls it
        monkeypatch.setattr(tfa, "PIPELINE_FWD", True)
        o, lse = tfa.flash_fwd(q, k, v, 0.125)
        monkeypatch.setattr(tfa, "PIPELINE_FWD", False)
        so, slse = tfa.flash_fwd(q, k, v, 0.125)
        assert o.is_contiguous()
        q, k, v, o, so = (tfa._to3d(x) for x in (q, k, v, o, so))
    else:
        o, lse = tfa.flash_fwd_3d_pipelined(q, k, v, 0.125)
        so, slse = tfa.flash_fwd_3d(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert tfa.flash_attention.pipelined_launches == before + 1
    ro, rlse = tfa.flash_fwd_pipelined_reference(q, k, v, 0.125)
    for other, other_lse in ((ro, rlse), (so, slse)):
        # o rounded once to bf16 on each side: 3 half-ulps of max |ref|,
        # relative L2 2e-3; the LSE is fp32
        diff = o.float() - other.float()
        assert diff.abs().max() <= 3 * other.float().abs().max() * 2.0 ** -8
        assert diff.norm() / other.float().norm() <= 2e-3
        assert (lse - other_lse).abs().max() <= 1e-4


@pytest.mark.cuda
def test_cuda_wrapper_raises_and_does_not_fall_back():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    q, k, v = (torch.randn((1, n, 64), device="cuda", dtype=torch.bfloat16)
               for n in (64, 577, 577))
    before = (tfa.flash_attention.launches,
              tfa.flash_attention.pipelined_launches)
    with pytest.raises(ValueError):
        tfa.flash_fwd_3d_pipelined(q, k, v, 0.125)
    with pytest.raises(ValueError):
        tfa.flash_fwd_3d_pipelined(q.half(), k[:, :128].half(),
                                   v[:, :128].half(), 0.125)
    assert before == (tfa.flash_attention.launches,
                      tfa.flash_attention.pipelined_launches)
