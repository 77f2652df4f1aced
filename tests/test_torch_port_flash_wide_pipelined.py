"""PyTorch port, the deferred-softmax flash forward at the wide head_dims,
512 and 256 (the VAE mid-block's single head at SD2 width and at
``small_config``): ``csrc/flash_wide.cu``'s ``fwd_deferred_kernel`` at 512,
``csrc/flash_d256_sm90.cu``'s deferred schedule at 256.

On the CPU the same numpy-seeded inputs go through the JAX package's
``_flash_fwd_3d_pipelined`` (the Pallas kernel in interpret mode, as
tests/test_torch_port_flash_pipelined.py runs it at head_dim 64) and through
the port's plain version at the deferred kernels' kv tile
(``pipelined_block_kv``: 32 at 512, ``D256_FWD_BLOCK_KV`` at 256);
gradients go through ``FlashAttentionFn`` with both packages' switches
on, so the backward consumes the pipelined
forward's LSE; and the dispatch rule by width.  The CUDA kernel is held to
its plain version and to the standard wide kernel on a card (``cuda``
marker; skipped elsewhere).  This file imports only ``diffute_tpu.ops`` of
the JAX package, so the card's image (jax without flax) runs its ``cuda``
tests.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffute_tpu.ops import flash_attention as jfa
from port_threads import torch_threads_per_worker  # noqa: F401

tfa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")

WIDTHS = (512, 256)
LN2 = 0.6931471805599453


def _qkv(seed, bh, s, t, d, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal((bh, n, d)).astype(dtype)
                 for n in (s, t, t))


def _jax_pipelined(q, k, v, scale, block_q, block_kv, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_fwd_3d_pipelined(
            jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            scale, block_q, block_kv)
    return np.asarray(o, np.float32), np.asarray(lse)[..., 0]


def test_the_kv_tile_follows_the_head_dim():
    # at 256 the deferred kernel walks the standard forward's tile
    # (csrc/flash_d256_sm90.cu), at 512 csrc/flash_wide.cu's 32 rows
    assert [tfa.pipelined_block_kv(d) for d in (64, 256, 512)] == [
        64, tfa.D256_FWD_BLOCK_KV, 32]
    assert all(tfa.pipelined_block_kv(d) == tfa.kernel_block_kv(
        d, torch.bfloat16, kind) for d in WIDTHS
        for kind in ("fwd", "fwd_pipelined"))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("s,t,block_q,block_kv", [
    (128, 256, 128, 128), (128, 640, 128, 128)])
def test_plain_version_matches_jax_kernel_fp32(s, t, block_q, block_kv, d):
    q, k, v = _qkv(0, 1, s, t, d)
    scale = d ** -0.5
    jo, jlse = _jax_pipelined(q, k, v, scale, block_q, block_kv)
    o, lse = tfa.flash_fwd_pipelined_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), scale,
        tfa.pipelined_block_kv(d))
    # fp32 on both sides, another tile size and q pre-scaled there, scores
    # scaled here: tests/test_flash_attention.py's bounds
    np.testing.assert_allclose(o.numpy(), jo, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5, rtol=0)
    # the 3-D entry takes the same route on a CPU tensor
    o3, lse3 = tfa.flash_fwd_3d_pipelined(
        *(torch.from_numpy(x) for x in (q, k, v)), scale)
    assert torch.equal(o3, o) and torch.equal(lse3, lse)


@pytest.mark.parametrize("d", WIDTHS)
def test_plain_version_matches_jax_kernel_bf16(d):
    q, k, v = _qkv(1, 1, 256, 256, d)
    jo, _ = _jax_pipelined(q, k, v, d ** -0.5, 128, 128, jnp.bfloat16)
    o, _ = tfa.flash_fwd_pipelined_reference(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), d ** -0.5,
        tfa.pipelined_block_kv(d))
    assert o.dtype == torch.bfloat16
    # both round o once to bf16 (and p before p v; JAX also q * scale): one
    # bf16 ulp of the largest output, as at head_dim 64
    ulp = float(np.abs(jo).max()) * 2.0 ** -7
    assert float(np.abs(o.float().numpy() - jo).max()) <= ulp


@pytest.mark.parametrize("d", WIDTHS)
def test_gradients_through_the_pipelined_lse_match_jax(monkeypatch, d):
    # T = 2048 in two 1024-wide kv blocks: JAX's dispatcher takes its
    # pipelined kernel; the port's, tiles of pipelined_block_kv(d)
    rng = np.random.RandomState(5)
    q, k, v, g = (rng.standard_normal((1, n, 1, d)).astype(np.float32)
                  for n in (128, 2048, 2048, 128))
    monkeypatch.setattr(jfa, "PIPELINE_FWD", True)
    jcalls = []
    jreal = jfa._flash_fwd_3d_pipelined
    monkeypatch.setattr(jfa, "_flash_fwd_3d_pipelined",
                        lambda *a: jcalls.append(1) or jreal(*a))

    def loss(q, k, v):
        with pltpu.force_tpu_interpret_mode():
            out = jfa.flash_attention(q, k, v, None, 128, 1024)
        return jnp.sum(out * g)

    g_jax = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    assert jcalls == [1]

    monkeypatch.setattr(tfa, "PIPELINE_FWD", True)
    calls = []
    real = tfa.flash_fwd_pipelined_reference  # the switch's CPU route
    monkeypatch.setattr(tfa, "flash_fwd_pipelined_reference",
                        lambda *a: calls.append(a[-1]) or real(*a))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tfa.flash_attention(*leaves).backward(torch.from_numpy(g))
    # the forward took the switch
    assert calls == [tfa.pipelined_block_kv(d)]
    for name, leaf, ref in zip("qkv", leaves, g_jax):
        # fp32 on both sides: tests/test_torch_port_flash_d512.py's bound
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("switch,t,pipelined", [
    (False, 4096, False),   # switch off
    (True, 4096, True),     # whole tiles (of 32 at 512, 64 at 256)
    (True, 1500, False),    # not a multiple of the tile: the standard kernel
    (True, "one tile", False),
    (True, "two tiles", True)])
def test_dispatch_rule(monkeypatch, switch, t, pipelined, d):
    bkv = tfa.pipelined_block_kv(d)
    t = {"one tile": bkv, "two tiles": 2 * bkv}.get(t, t)
    monkeypatch.setattr(tfa, "PIPELINE_FWD", switch)
    taken = []
    for name in ("flash_fwd_pipelined_reference", "flash_attention_reference"):
        real = getattr(tfa, name)
        monkeypatch.setattr(
            tfa, name, lambda *a, _n=name, _r=real: taken.append(_n) or _r(*a))
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 4, t, d))
    o, lse = tfa.flash_fwd_3d(q, k, v, d ** -0.5)
    assert o.shape == q.shape and lse.shape == (1, 4)
    assert taken == ["flash_fwd_pipelined_reference" if pipelined
                     else "flash_attention_reference"]
    assert tfa._pipelined_takes(t, d) == (t in (4096, 2 * bkv))


@pytest.mark.parametrize("d", WIDTHS)
def test_wrapper_raises_on_what_the_kernel_does_not_take(d):
    # 1500 keys, and one tile
    bkv = tfa.pipelined_block_kv(d)
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 8, 1500, d))
    with pytest.raises(ValueError, match=f"multiple of {bkv}"):
        tfa.flash_fwd_3d_pipelined(q, k, v, d ** -0.5)
    with pytest.raises(ValueError, match=f"multiple of {bkv}"):
        tfa.flash_fwd_3d_pipelined(q, k[:, :bkv], v[:, :bkv], d ** -0.5)


def test_pipelined_launches_are_counted_by_width():
    names = ("launches", "pipelined_launches", "d512_launches",
             "d512_pipelined_launches", "d256_launches",
             "d256_pipelined_launches")
    for d, pipelined, counter in ((512, True, "d512_pipelined_launches"),
                                  (256, True, "d256_pipelined_launches"),
                                  (512, False, "d512_launches"),
                                  (64, True, "pipelined_launches")):
        # bf16: the kernels these counters count (fp32 inputs count in the
        # fp32 kernels' own: tests/test_torch_port_flash_fp32.py)
        q, k = (torch.empty((1, n, 1, d), device="meta", dtype=torch.bfloat16)
                for n in (64, 4096))
        before = {n: getattr(tfa.flash_attention, n) for n in names}
        tfa._count_forward(q, k, pipelined)
        assert {n: getattr(tfa.flash_attention, n) - before[n]
                for n in names} == {n: int(n == counter) for n in names}


def _wrong_parity(q, k, v, scale, bkv):
    """A mutant of the plain version: tile j's softmax takes tile j - 1's
    scores (the partial buffer of the wrong parity), with v_j."""
    shifted = torch.cat([k[:, :bkv], k[:, :-bkv]], 1)
    return tfa.flash_fwd_tiled_reference(q, shifted, v, scale, bkv)


def test_mutants_fail_the_bounds():
    # an LSE left in base 2, a last tile never consumed and the scores of
    # the wrong parity are far outside the bounds the kernel is held to
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 2, 64, 256, 256))
    bkv = tfa.pipelined_block_kv(256)
    o, lse = tfa.flash_fwd_pipelined_reference(q, k, v, 0.0625, bkv)
    assert float((lse / LN2 - lse).abs().max()) > 1.0
    mo, mlse = tfa.flash_fwd_tiled_reference(q, k[:, :-bkv], v[:, :-bkv],
                                             0.0625, bkv)
    assert float((mlse - lse).abs().max()) > 1e-2
    assert float((mo - o).norm() / o.norm()) > 1e-1
    wo, wlse = _wrong_parity(q, k, v, 0.0625, bkv)
    assert float((wo - o).norm() / o.norm()) > 1e-1


# ---------------------------------------------------------------------------
# On the card: the deferred kernel against its plain version at the kernels'
# kv tile, at the criteria of the other flash forwards (o within 3 half-ulps
# of max |ref| and relative L2 2e-3, the LSE within 1e-4), and against the
# standard wide kernel on the same inputs: the same arithmetic in another
# order, so the same bits.
# ---------------------------------------------------------------------------

HALF_ULPS, TOL_FWD_REL_L2, TOL_LSE = 3, 2e-3, 1e-4


def _fwd_held(o, lse, ro, rlse):
    diff, ref = o.float() - ro.float(), ro.float()
    return (diff.abs().max().item()
            <= HALF_ULPS * ref.abs().max().item() * 2.0 ** -8
            and (diff.norm() / ref.norm()).item() <= TOL_FWD_REL_L2
            and (lse - rlse).abs().max().item() <= TOL_LSE)


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")


def _cuda_qkv(seed, bh, s, t, d):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((bh, n, d), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for n in (s, t, t))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t,d", [
    (4, 4096, 4096, 512), (1, 1000, 2048, 512), (2, 64, 64, 512),
    (16, 4096, 4096, 256), (3, 1000, 1024, 256), (1, 33, 128, 256)])
def test_cuda_kernel_matches_plain_and_standard(bh, s, t, d):
    _skip_without_card()
    q, k, v = _cuda_qkv(0, bh, s, t, d)
    scale = d ** -0.5
    fa = tfa.flash_attention
    before = (fa.launches, fa.d512_launches, fa.d256_launches,
              fa.d512_pipelined_launches, fa.d256_pipelined_launches)
    o, lse = tfa.flash_fwd_3d_pipelined(q, k, v, scale)
    o2, lse2 = tfa.flash_fwd_3d_pipelined(q, k, v, scale)
    so, slse = tfa.flash_fwd_3d(q, k, v, scale)
    torch.cuda.synchronize()
    assert (fa.launches, fa.d512_launches, fa.d256_launches,
            fa.d512_pipelined_launches, fa.d256_pipelined_launches) == (
        before[0], before[1] + (d == 512), before[2] + (d == 256),
        before[3] + 2 * (d == 512), before[4] + 2 * (d == 256))
    ro, rlse = tfa.flash_fwd_pipelined_reference(q, k, v, scale,
                                                 tfa.pipelined_block_kv(d))
    assert _fwd_held(o, lse, ro, rlse)
    # no atomics: the same bits twice; and the standard kernel's bits
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o, so) and torch.equal(lse, slse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_kernel_reads_strided_views_through_the_switch(monkeypatch, d):
    _skip_without_card()
    # q, k, v as (B, S, 1, D) views of one packed (B, S, 3, 1, D)
    # projection: the same bits as the contiguous route
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, 4096, 3, 1, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    q, k, v = (x[:, :, i] for i in range(3))
    assert not q.is_contiguous()
    monkeypatch.setattr(tfa, "PIPELINE_FWD", True)
    counter = f"d{d}_pipelined_launches"
    before = getattr(tfa.flash_attention, counter)
    o, lse = tfa.flash_fwd(q, k, v, d ** -0.5)
    o2, lse2 = tfa.flash_fwd(*(y.contiguous() for y in (q, k, v)), d ** -0.5)
    torch.cuda.synchronize()
    assert getattr(tfa.flash_attention, counter) == before + 2
    assert o.is_contiguous() and torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = tfa.flash_fwd_pipelined_reference(
        *(tfa._to3d(y) for y in (q, k, v)), d ** -0.5,
        tfa.pipelined_block_kv(d))
    assert _fwd_held(tfa._to3d(o), lse, ro, rlse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_mutants_fail_the_criteria(d):
    _skip_without_card()
    q, k, v = _cuda_qkv(1, 4, 4096, 4096, d)
    scale, bkv = d ** -0.5, tfa.pipelined_block_kv(d)
    o, lse = tfa.flash_fwd_pipelined_reference(q, k, v, scale, bkv)
    assert _fwd_held(*tfa.flash_fwd_3d_pipelined(q, k, v, scale), o, lse)
    # the LSE left in base 2; the last kv tile never consumed; tile j's
    # softmax on tile j - 1's scores
    assert not _fwd_held(o, lse / LN2, o, lse)
    assert not _fwd_held(*tfa.flash_fwd_tiled_reference(
        q, k[:, :-bkv], v[:, :-bkv], scale, bkv), o, lse)
    assert not _fwd_held(*_wrong_parity(q, k, v, scale, bkv), o, lse)


@pytest.mark.cuda
def test_cuda_ragged_t_takes_the_standard_kernel(monkeypatch):
    _skip_without_card()
    q, k, v = _cuda_qkv(4, 2, 1000, 1500, 512)
    monkeypatch.setattr(tfa, "PIPELINE_FWD", True)
    fa = tfa.flash_attention
    before = (fa.d512_launches, fa.d512_pipelined_launches)
    o, lse = tfa.flash_fwd_3d(q, k, v, 512 ** -0.5)
    torch.cuda.synchronize()
    assert (fa.d512_launches, fa.d512_pipelined_launches) == (
        before[0] + 1, before[1])
    with pytest.raises(ValueError, match="multiple of 32"):
        tfa.flash_fwd_3d_pipelined(q, k, v, 512 ** -0.5)
    assert (fa.d512_launches, fa.d512_pipelined_launches) == (
        before[0] + 1, before[1])
