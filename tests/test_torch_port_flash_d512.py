"""PyTorch port, flash attention at the wide head_dims, 512 and 256 (the VAE
mid-block's single head at SD2 width and at ``small_config``): the plain
forward and backward on the CPU against the JAX package's flash attention
and ``jax.grad`` through it (Pallas kernels in interpret mode, as
tests/test_flash_attention.py runs them), the tiled plain versions at
``csrc/flash_wide.cu``'s kv tile against the one-pass ones, the wrappers'
refusals, and the forward's FLOP count (the deferred-softmax forward at
these widths: tests/test_torch_port_flash_wide_pipelined.py).  Each case
runs at both widths; a head_dim-512 case keeps the test id it had before
head_dim 256 was added.

The CUDA kernels run only on a card: their tests are marked ``cuda`` and
skip elsewhere.  This file imports only ``diffute_tpu.ops`` of the JAX
package, so the card's image (jax without flax) runs its ``cuda`` tests.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffute_tpu.ops.flash_attention as jfa

from diffute_tpu_torch.ops import flash_attention
from diffute_tpu_torch.ops.flash_attention import (
    WIDE_BLOCK_KV,
    _to3d,
    flash_attention_reference,
    flash_bwd,
    flash_bwd_3d,
    flash_bwd_reference,
    flash_bwd_tiled_reference,
    flash_fwd,
    flash_fwd_3d,
    flash_fwd_tiled_reference,
)

tfa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")

# the widths csrc/flash_wide.cu is instantiated at
WIDTHS = (512, 256)
# fp32 on both sides, as tests/test_torch_port_attention.py and
# tests/test_torch_port_flash_bwd.py hold head_dim 64: the two differ only
# in summation order (the Pallas kernels sum per block with an online
# rescale), 2e-5 on outputs and gradients, 1e-5 on the LSE
ATOL, ATOL_LSE = 2e-5, 1e-5


def _inputs(seed, b, s, t, h, d):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d),
                               (b, s, h, d)))


def _wide(cases, name=lambda c: "-".join(map(str, c))):
    """``cases`` at each width: pytest params of (*case, d), whose id is the
    case's at 512 (as before head_dim 256 was added) and ends in -d256 at
    256."""
    return [pytest.param(*c, d, id=name(c) + ("" if d == 512 else f"-d{d}"))
            for d in WIDTHS for c in cases]


@functools.lru_cache(maxsize=None)
def _jax_results(b, s, t, h, d):
    """The JAX flash forward's o and LSE, and jax.grad of
    sum(flash_attention(q, k, v) * g), on _inputs(0, ...)."""
    q, k, v, g = (jnp.asarray(x) for x in _inputs(0, b, s, t, h, d))
    out, (_, _, _, _, lse) = jfa._flash_fwd_rule(q, k, v, None, None, None)
    grads = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v) * g),
                     argnums=(0, 1, 2))(q, k, v)
    return (np.asarray(out), np.asarray(lse)[..., 0],
            tuple(np.asarray(x) for x in grads))


# (B, S, T, H): a square tile-aligned case, a ragged one whose T spans
# three of JAX's kv blocks, and two heads
JAX_SHAPES = [(1, 256, 256, 1), (1, 300, 1100, 1), (1, 256, 256, 2)]


WIDE_COUNTERS = ("d512_launches", "d512_bwd_dq_launches",
                 "d512_bwd_dkv_launches", "d256_launches",
                 "d256_bwd_dq_launches", "d256_bwd_dkv_launches")


def _counts():
    return [getattr(flash_attention, n) for n in WIDE_COUNTERS]


@pytest.mark.parametrize("b,s,t,h,d", _wide(JAX_SHAPES))
def test_plain_forward_matches_jax_flash(b, s, t, h, d):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(0, b, s, t, h, d))
    j_out, j_lse, _ = _jax_results(b, s, t, h, d)
    before = _counts()
    o, lse = flash_fwd(q, k, v, d ** -0.5)  # CPU tensors: the plain version
    assert _counts() == before
    np.testing.assert_allclose(o.numpy(), j_out, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=ATOL_LSE, rtol=0)
    np.testing.assert_allclose(flash_attention(q, k, v).numpy(), j_out,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,s,t,h,d", _wide(JAX_SHAPES))
def test_plain_backward_matches_jax_grad(b, s, t, h, d):
    q, k, v, g = _inputs(0, b, s, t, h, d)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = _counts()
    flash_attention(tq, tk, tv).backward(torch.from_numpy(g))
    assert _counts() == before
    for name, mine, ref in zip("qkv", (tq, tk, tv),
                               _jax_results(b, s, t, h, d)[2]):
        np.testing.assert_allclose(mine.grad.numpy(), ref, atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


# bf16: the tiled versions round p (and ds) against the running max (the
# saved LSE) kv tile by kv tile and the one-pass versions round only their
# outputs; at head_dim 64 the backward pair differed by about 2.6e-3 in
# relative L2 (tests/test_torch_port_flash_bwd.py), within 5e-3
TILED_VS_ONE_PASS_REL_L2 = 5e-3


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,t,d", _wide([(2, 96, 96), (1, 70, 130)]))
def test_tiled_plain_versions_at_the_kernels_tile_match_one_pass(dtype, bh, s,
                                                                 t, d):
    # 96 and 130 keys: three tiles and a short last one (130 = 4 * 32 + 2)
    q, k, v, g = (torch.from_numpy(x[0].transpose(1, 0, 2)).to(dtype)
                  for x in _inputs(5, 1, s, t, bh, d))
    scale, bkv = d ** -0.5, WIDE_BLOCK_KV
    o, lse = flash_attention_reference(q, k, v, scale)
    to, tlse = flash_fwd_tiled_reference(q, k, v, scale, bkv)
    got = flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)
    ref = flash_bwd_reference(q, k, v, o, lse, g, scale)
    np.testing.assert_allclose(tlse.numpy(), lse.numpy(), atol=ATOL_LSE,
                               rtol=0)
    for name, mine, r in (("o", to, o), *zip(("dq", "dk", "dv"), got, ref)):
        assert mine.dtype == r.dtype == dtype and mine.shape == r.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(mine.numpy(), r.numpy(), atol=ATOL,
                                       rtol=0, err_msg=name)
        else:
            assert _rel_l2(mine, r) <= TILED_VS_ONE_PASS_REL_L2, name


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


# fp16 is the dtype no kernel takes (fp32 has kernels since
# csrc/flash_fp32.cu; the message reads "take bf16 or fp32")
@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 512, "take bf16"),
    (torch.bfloat16, 128, r"D in \(64, 256, 512\)"),
    # head_dim 512 passes every check but the device's
    (torch.bfloat16, 512, "runs on cuda or cpu, not meta"),
    (torch.float16, 256, "take bf16"),
    (torch.bfloat16, 256, "runs on cuda or cpu, not meta")])
def test_wrappers_refuse_what_the_kernels_do_not_take(dtype, d, match):
    q, k, v, o, do = (_meta(1, n, 1, d, dtype=dtype)
                      for n in (256, 1024, 1024, 256, 256))
    lse = _meta(1, 256, dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        flash_fwd(q, k, v, d ** -0.5)
    with pytest.raises(ValueError, match=match):
        tfa.flash_bwd_dq(q, k, v, o, lse, do, d ** -0.5)
    with pytest.raises(ValueError, match=match):
        tfa.flash_bwd_dkv(q, k, v, do, lse, lse, d ** -0.5)


@pytest.mark.parametrize("d,counter", [(512, "d512_launches"),
                                       (64, "launches"),
                                       (256, "d256_launches")])
def test_forward_flops_count_the_real_head_dim(d, counter):
    # edit_profiled adds these FLOPs to each stage: 4 B H S T D, with D the
    # head_dim the kernel ran at
    q, k = _meta(2, 300, 3, d), _meta(2, 1100, 3, d)
    names = ("launches", "pipelined_launches", "d512_launches",
             "d256_launches")
    before = {n: getattr(flash_attention, n) for n in names}
    flops = flash_attention.flops
    tfa._count_forward(q, k, pipelined=False)
    assert flash_attention.flops - flops == 4 * 2 * 3 * 300 * 1100 * d
    assert {n: getattr(flash_attention, n) - before[n] for n in names} == {
        n: int(n == counter) for n in names}


# ---------------------------------------------------------------------------
# On the card: each kernel against its tiled plain version at the kernels'
# kv tile, at the head_dim-64 criteria (tests/test_torch_port_attention.py,
# tests/test_torch_port_flash_bwd.py): o within 3 half-ulps of max |ref| and
# relative L2 2e-3, the LSE within 1e-4; dq, dk, dv within 3 half-ulps and
# relative L2 1e-3; delta within 1e-5.
# ---------------------------------------------------------------------------

HALF_ULPS, TOL_FWD_REL_L2, TOL_LSE = 3, 2e-3, 1e-4
TOL_BWD_REL_L2, TOL_DELTA = 1e-3, 1e-5


def _held(got, ref, rel_l2):
    diff, ref = got.float() - ref.float(), ref.float()
    return (diff.abs().max().item()
            <= HALF_ULPS * ref.abs().max().item() * 2.0 ** -8
            and (diff.norm() / ref.norm()).item() <= rel_l2)


def _fwd_held(o, lse, ro, rlse):
    return (_held(o, ro, TOL_FWD_REL_L2)
            and (lse - rlse).abs().max().item() <= TOL_LSE)


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")


def _cuda_inputs(seed, bh, s, t, d):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((bh, n, d), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for n in (s, t, t, s))


# (B*H, S, T): stage 1's step at 512^2 (batch 4 at head_dim 512, batch 16
# at 256), and a ragged one
CUDA_SHAPES = {512: [(4, 4096, 4096), (2, 1000, 1500)],
               256: [(16, 4096, 4096), (2, 1000, 1500)]}


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t,d", [
    pytest.param(*c, d, id="-".join(map(str, c)) + ("" if d == 512
                                                    else f"-d{d}"))
    for d in WIDTHS for c in CUDA_SHAPES[d]])
def test_cuda_kernels_match_tiled_plain(bh, s, t, d):
    _skip_without_card()
    q, k, v, g = _cuda_inputs(0, bh, s, t, d)
    scale, bkv = d ** -0.5, WIDE_BLOCK_KV
    counters = (f"d{d}_launches", f"d{d}_bwd_dq_launches",
                f"d{d}_bwd_dkv_launches")
    before = _counts(), flash_attention.launches
    o, lse = flash_fwd_3d(q, k, v, scale)
    dq, delta = tfa.flash_bwd_dq_3d(q, k, v, o, lse, g, scale)
    dk, dv = tfa.flash_bwd_dkv_3d(q, k, v, g, lse, delta, scale)
    torch.cuda.synchronize()
    # one launch of each kernel of this width, none of another
    assert (_counts(), flash_attention.launches) == (
        [n + (name in counters) for n, name in zip(before[0], WIDE_COUNTERS)],
        before[1])
    ro, rlse = flash_fwd_tiled_reference(q, k, v, scale, bkv)
    assert _fwd_held(o, lse, ro, rlse)
    assert (delta - tfa._delta(o, g)).abs().max().item() <= TOL_DELTA
    ref = flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)
    for name, mine, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert _held(mine, r, TOL_BWD_REL_L2), name
    # no atomics: a second call gives the same bits
    o2, lse2 = flash_fwd_3d(q, k, v, scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(
        (dq, dk, dv), flash_bwd_3d(q, k, v, o, lse, g, scale)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_mutants_fail_the_criteria(d):
    _skip_without_card()
    q, k, v, g = _cuda_inputs(1, 4, 4096, 4096, d)
    scale, bkv = d ** -0.5, WIDE_BLOCK_KV
    o, lse = flash_fwd_tiled_reference(q, k, v, scale, bkv)
    assert _fwd_held(*flash_fwd_3d(q, k, v, scale), o, lse)
    # the LSE left in base 2; the last kv tile never consumed
    assert not _fwd_held(o, lse / 0.6931471805599453, o, lse)
    cut = k.shape[1] - bkv
    assert not _fwd_held(*flash_fwd_tiled_reference(
        q, k[:, :cut], v[:, :cut], scale, bkv), o, lse)
    dq, dk, dv = flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)
    assert _held(dk, dk, TOL_BWD_REL_L2)
    assert not _held(dk.float() * 1.02, dk, TOL_BWD_REL_L2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_kernels_read_strided_views_without_a_copy(d):
    _skip_without_card()
    # q, k, v, dO as (B, S, 1, D) views of one packed (B, S, 4, 1, D)
    # projection: the same bits as the contiguous route
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, 4096, 4, 1, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    q, k, v, g = (x[:, :, i] for i in range(4))
    assert not q.is_contiguous()
    scale = d ** -0.5
    o, lse = flash_fwd(q, k, v, scale)
    grads = flash_bwd(q, k, v, o, lse, g, scale)
    flat = [y.contiguous() for y in (q, k, v, g)]
    o2, lse2 = flash_fwd(*flat[:3], scale)
    assert o.is_contiguous() and torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b in zip(grads, flash_bwd(*flat[:3], o2, lse2, flat[3], scale)):
        assert a.is_contiguous() and a.shape == q.shape and torch.equal(a, b)
    ro, rlse = flash_fwd_tiled_reference(*(_to3d(y) for y in (q, k, v)),
                                         scale, WIDE_BLOCK_KV)
    assert _fwd_held(_to3d(o), lse, ro, rlse)


@pytest.mark.cuda
@pytest.mark.parametrize("switch", [False, True])
def test_cuda_refusals_launch_nothing(monkeypatch, switch):
    _skip_without_card()
    # fp16, and head_dims no kernel takes, raise with PIPELINE_FWD off or on
    # (1024 keys: the deferred kernel's rule takes them at every width);
    # neither a bf16 nor an fp32 kernel launches
    monkeypatch.setattr(tfa, "PIPELINE_FWD", switch)
    q, k, v, _ = _cuda_inputs(3, 1, 1024, 1024, 512)
    counts = ("launches", "pipelined_launches", "d512_pipelined_launches",
              "d256_pipelined_launches", *WIDE_COUNTERS,
              *(tfa.counter_name(kind, d, torch.float32)
                for kind in ("fwd", "fwd_pipelined") for d in WIDTHS))
    before = [getattr(flash_attention, n) for n in counts]
    for d in WIDTHS:
        with pytest.raises(ValueError, match="take bf16"):
            flash_fwd_3d(q[..., :d].half(), k[..., :d].half(),
                         v[..., :d].half(), d ** -0.5)
    for d in (128, 384):
        with pytest.raises(ValueError, match=r"D in \(64, 256, 512\)"):
            flash_fwd_3d(q[..., :d], k[..., :d], v[..., :d], d ** -0.5)
    assert before == [getattr(flash_attention, n) for n in counts]
