"""PyTorch port, flash attention at the wide head_dims, 512 and 256 (the VAE
mid-block's single head at SD2 width and at ``small_config``): the plain
forward and backward on the CPU against the JAX package's flash attention
and ``jax.grad`` through it (Pallas kernels in interpret mode, as
tests/test_flash_attention.py runs them), the tiled plain versions at
``csrc/flash_wide.cu``'s kv tile against the one-pass ones, the wrappers'
refusals, and the forward's FLOP count (the deferred-softmax forward at
these widths: tests/test_torch_port_flash_wide_pipelined.py).  Each case
runs at both widths; a head_dim-512 case keeps the test id it had before
head_dim 256 was added.  The kernels at 256 walk kv tiles of their own:
the forwards (``csrc/flash_d256_sm90.cu``) ``kernel_block_kv(256, bf16,
"fwd")``, dq and dk/dv (``csrc/flash_d256_bwd_sm90.cu``)
``kernel_block_kv(256, bf16, "bwd_dq")``; every kernel at 512, 32 rows.

The CUDA kernels run only on a card: their tests are marked ``cuda`` and
skip elsewhere.  This file imports only ``diffute_tpu.ops`` of the JAX
package, so the card's image (jax without flax) runs its ``cuda`` tests.
"""

import functools
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffute_tpu.ops.flash_attention as jfa

from diffute_tpu_torch.ops import flash_attention
from diffute_tpu_torch.ops.flash_attention import (
    _to3d,
    flash_attention_reference,
    flash_bwd,
    flash_bwd_3d,
    flash_bwd_reference,
    flash_bwd_tiled_reference,
    flash_fwd,
    flash_fwd_3d,
    flash_fwd_tiled_reference,
    kernel_block_kv,
)
from port_threads import torch_threads_per_worker  # noqa: F401

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


def _tiles(d):
    """The kv tiles of the bf16 forward and backward kernels at ``d``."""
    return (kernel_block_kv(d, torch.bfloat16, "fwd"),
            kernel_block_kv(d, torch.bfloat16, "bwd_dq"))


def test_the_forwards_at_256_walk_a_tile_of_their_own(monkeypatch):
    # the forwards at 256 walk csrc/flash_d256_sm90.cu's tile, both the
    # same (the deferred one gives the standard one's bits); dq and dk/dv
    # at 256 csrc/flash_d256_bwd_sm90.cu's (64 rows, as the forwards'), and
    # every kernel at 512 csrc/flash_wide.cu's 32 rows
    assert _tiles(256) == (tfa.D256_FWD_BLOCK_KV, tfa.D256_BWD_BLOCK_KV) == (
        64, 64)
    assert kernel_block_kv(256, torch.bfloat16, "fwd_pipelined") == \
        tfa.D256_FWD_BLOCK_KV == tfa.pipelined_block_kv(256)
    assert _tiles(512) == (32, 32) == (kernel_block_kv(512, torch.bfloat16),
                                       tfa.pipelined_block_kv(512))
    assert kernel_block_kv(256, torch.bfloat16, "bwd_dkv") == \
        tfa.D256_BWD_BLOCK_KV == kernel_block_kv(256, torch.bfloat16)
    # where the four kernels walk different tiles, the kind must be named
    monkeypatch.setattr(tfa, "D256_BWD_BLOCK_KV", 32)
    with pytest.raises(ValueError, match="name the kind"):
        kernel_block_kv(256, torch.bfloat16)
    with pytest.raises(ValueError, match="kind must be one of"):
        kernel_block_kv(256, torch.bfloat16, "bwd")


def test_the_d256_source_walks_the_tile_the_wrappers_count_in():
    # the dispatch rule and the plain versions count in D256_FWD_BLOCK_KV;
    # csrc/flash_d256_sm90.cu fixes its kv tile at build time
    source = os.path.join(os.path.dirname(tfa.__file__), os.pardir, "csrc",
                          "flash_d256_sm90.cu")
    with open(source) as f:
        tiles = re.findall(r"constexpr int kBlockKV = (\d+);", f.read())
    assert tiles == [str(tfa.D256_FWD_BLOCK_KV)]


def test_the_d256_backward_source_walks_the_tile_the_wrappers_count_in():
    # the tiled plain backward and phase 3d count in D256_BWD_BLOCK_KV;
    # csrc/flash_d256_bwd_sm90.cu fixes the dq kernel's kv tile, the dk/dv
    # kernel's q tile and both kernels' resident rows at build time
    source = os.path.join(os.path.dirname(tfa.__file__), os.pardir, "csrc",
                          "flash_d256_bwd_sm90.cu")
    with open(source) as f:
        text = f.read()
    for name in ("kBlockKV", "kRows"):
        assert re.findall(rf"constexpr int {name} = (\d+);", text) == [
            str(tfa.D256_BWD_BLOCK_KV)], name


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
def test_tiled_plain_forward_at_the_kernels_tile_matches_jax_flash(b, s, t,
                                                                   h, d):
    # fp32 at the forward kernels' own kv tile (64 rows at 256, 32 at 512):
    # the JAX forward (Pallas in interpret mode) sums per block with an
    # online rescale too, in other blocks, so the bounds are ATOL and
    # ATOL_LSE as for the one-pass plain version
    q, k, v, _ = (_to3d(torch.from_numpy(x))
                  for x in _inputs(0, b, s, t, h, d))
    j_out, j_lse, _ = _jax_results(b, s, t, h, d)
    o, lse = flash_fwd_tiled_reference(q, k, v, d ** -0.5, _tiles(d)[0])
    j_out = _to3d(torch.from_numpy(np.array(j_out)))
    np.testing.assert_allclose(o.numpy(), j_out, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=ATOL_LSE, rtol=0)


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


@pytest.mark.parametrize("b,s,t,h", JAX_SHAPES + [(1, 70, 130, 1)])
def test_tiled_plain_backward_at_the_kernels_tile_matches_jax_grad(b, s, t,
                                                                   h):
    # fp32 at head_dim 256, at the backward kernels' own tile (64 rows; 130
    # keys are two tiles and a short one, 1100 seventeen and a short one),
    # fed the JAX forward's o and LSE, against jax.grad through its flash
    # attention (_flash_bwd_3d's Pallas kernels in interpret mode): the two
    # differ only in summation order, so the bound is ATOL as for the
    # one-pass plain version
    d = 256
    q, k, v, g = (_to3d(torch.from_numpy(x))
                  for x in _inputs(0, b, s, t, h, d))
    j_out, j_lse, j_grads = _jax_results(b, s, t, h, d)
    o = _to3d(torch.from_numpy(np.array(j_out)))
    lse = torch.from_numpy(np.array(j_lse))
    grads = flash_bwd_tiled_reference(q, k, v, o, lse, g, d ** -0.5,
                                      _tiles(d)[1])
    for name, mine, ref in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(
            mine.numpy(), _to3d(torch.from_numpy(np.array(ref))).numpy(),
            atol=ATOL, rtol=0, err_msg=f"d{name}")


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
    # 96 and 130 keys: three 32-row tiles and a short last one (130 = 4 *
    # 32 + 2), or 64-row ones at 256 (130 = 2 * 64 + 2); the forward at its
    # kernel's tile, the backward at its own
    q, k, v, g = (torch.from_numpy(x[0].transpose(1, 0, 2)).to(dtype)
                  for x in _inputs(5, 1, s, t, bh, d))
    scale, (fwd_bkv, bkv) = d ** -0.5, _tiles(d)
    o, lse = flash_attention_reference(q, k, v, scale)
    to, tlse = flash_fwd_tiled_reference(q, k, v, scale, fwd_bkv)
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
    # a head_dim no kernel takes (every multiple of 8 up to 128 has one)
    (torch.bfloat16, 136, "64, 256, 512 or a multiple of 8 up to 128"),
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
    scale, (fwd_bkv, bkv) = d ** -0.5, _tiles(d)
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
    ro, rlse = flash_fwd_tiled_reference(q, k, v, scale, fwd_bkv)
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
    scale, (fwd_bkv, bkv) = d ** -0.5, _tiles(d)
    o, lse = flash_fwd_tiled_reference(q, k, v, scale, fwd_bkv)
    assert _fwd_held(*flash_fwd_3d(q, k, v, scale), o, lse)
    # the LSE left in base 2; the last kv tile never consumed
    assert not _fwd_held(o, lse / 0.6931471805599453, o, lse)
    cut = k.shape[1] - fwd_bkv
    assert not _fwd_held(*flash_fwd_tiled_reference(
        q, k[:, :cut], v[:, :cut], scale, fwd_bkv), o, lse)
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
                                         scale, _tiles(d)[0])
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
    for d in (136, 384):
        with pytest.raises(ValueError,
                           match="64, 256, 512 or a multiple of 8 up to 128"):
            flash_fwd_3d(q[..., :d], k[..., :d], v[..., :d], d ** -0.5)
    assert before == [getattr(flash_attention, n) for n in counts]


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("consumers", [1, 2])
@pytest.mark.parametrize("bh,s,t", [(16, 4096, 4096), (1, 4096, 4096),
                                    (2, 1000, 1500), (1, 33, 128)])
def test_cuda_d256_forwards_in_both_block_layouts(bh, s, t, consumers,
                                                  pipelined):
    # csrc/flash_d256_sm90.cu with one or two consumer warpgroups a block,
    # whichever the launcher takes by itself (d256_consumers): each
    # warpgroup computes its rows by the same instructions, so each layout
    # gives the launcher's bits, and the deferred forward the standard
    # one's; held to the tiled plain version at the forwards' tile
    _skip_without_card()
    fwd_bkv = _tiles(256)[0]
    if pipelined and not tfa._pipelined_takes(t, 256):
        with pytest.raises(ValueError, match=f"multiple of {fwd_bkv}"):
            tfa.flash_fwd_layout(*(x[:, :, None] for x in _cuda_inputs(
                4, bh, s, t, 256)[:3]), 0.0625, consumers, pipelined)
        return
    q, k, v, _ = (x[:, :, None] for x in _cuda_inputs(4, bh, s, t, 256))
    counter = "d256_pipelined_launches" if pipelined else "d256_launches"
    before = getattr(flash_attention, counter)
    o, lse = tfa.flash_fwd_layout(q, k, v, 0.0625, consumers, pipelined)
    o2, lse2 = tfa.flash_fwd_layout(q, k, v, 0.0625, consumers, pipelined)
    ao, alse = flash_fwd(q, k, v, 0.0625)  # the launcher's layout, standard
    torch.cuda.synchronize()
    assert getattr(flash_attention, counter) == before + 2 + (not pipelined)
    assert tfa.d256_consumers(bh, s) in (1, 2)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o, ao) and torch.equal(lse, alse)
    ro, rlse = flash_fwd_tiled_reference(*(_to3d(y) for y in (q, k, v)),
                                         0.0625, fwd_bkv)
    assert _fwd_held(_to3d(o), lse, ro, rlse)


@pytest.mark.cuda
@pytest.mark.parametrize("consumers", [1, 2])
def test_cuda_d256_layouts_read_strided_views(monkeypatch, consumers):
    # (B, S, 1, 256) views of one packed (B, S, 3, 1, 256) projection in
    # each block layout, both forwards: the contiguous route's bits
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((2, 4096, 3, 1, 256), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    q, k, v = (x[:, :, i] for i in range(3))
    o2, lse2 = flash_fwd(*(y.contiguous() for y in (q, k, v)), 0.0625)
    for pipelined in (False, True):
        o, lse = tfa.flash_fwd_layout(q, k, v, 0.0625, consumers, pipelined)
        assert o.is_contiguous()
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_cuda_d256_layouts_refuse_what_they_do_not_take():
    _skip_without_card()
    q, k, v, _ = (x[:, :, None] for x in _cuda_inputs(5, 1, 256, 256, 256))
    before = _counts()
    for consumers in (0, 3):
        with pytest.raises(ValueError, match="1 or 2 consumer warpgroups"):
            tfa.flash_fwd_layout(q, k, v, 0.0625, consumers)
    with pytest.raises(ValueError, match="1 or 2 consumer warpgroups"):
        tfa.flash_fwd_layout(q[..., :64], k[..., :64], v[..., :64], 0.125, 1)
    assert _counts() == before
