"""PyTorch port, flash attention on fp32 inputs (``csrc/flash_fp32.cu``):
the plain fp32 versions of the forward, the deferred-softmax forward and
the backward on the CPU against the JAX package's fp32 flash attention
(Pallas kernels in interpret mode, as tests/test_flash_attention.py runs
them) at head_dims 64, 256 and 512 with a ragged T; the TF32 mutant and the
other mutants that the card's bound must refuse; the wrappers' dtype and
layout checks, entry names and counters; the device numerics rule.

The precision contract (the head of ``csrc/flash_fp32.cu``): o, dq, dk and
dv within relative L2 1e-5, the LSE within 1e-5 absolute.  The CUDA
kernels run only on a card: their tests are marked ``cuda`` and skip
elsewhere.  This file imports only ``diffute_tpu.ops`` of the JAX package,
so the card's image (jax without flax) runs its ``cuda`` tests.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffute_tpu.ops.flash_attention as jfa

from diffute_tpu_torch.config import UNetConfig, VAEConfig
from diffute_tpu_torch.ops import _build
from diffute_tpu_torch.utils.device import configure_cuda_numerics

tfa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")

WIDTHS = (64, 256, 512)
# the precision contract: fp32 on both sides, the sums in other orders
REL_L2, LSE_ABS = 1e-5, 1e-5
KINDS = ("fwd", "fwd_pipelined", "bwd_dq", "bwd_dkv")


def _rel_l2(got, ref) -> float:
    got, ref = (torch.as_tensor(np.array(x)).float() for x in (got, ref))
    return ((got - ref).norm() / ref.norm()).item()


def _inputs(seed, b, s, t, h, d):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d),
                               (b, s, h, d)))


def _jax_fwd_and_grads(q, k, v, g):
    """The JAX fp32 flash forward's o and LSE (natural log, (BH, S)) and
    jax.grad of sum(flash_attention(q, k, v) * g), (B, L, H, D) arrays."""
    q, k, v, g = (jnp.asarray(x) for x in (q, k, v, g))
    out, (_, _, _, _, lse) = jfa._flash_fwd_rule(q, k, v, None, None, None)
    grads = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v) * g),
                     argnums=(0, 1, 2))(q, k, v)
    return (np.asarray(out), np.asarray(lse)[..., 0],
            [np.asarray(x) for x in grads])


def _to3d(x):
    return tfa._to3d(torch.from_numpy(np.array(x)))


# (B, S, T, H): S and T ragged against every width's tile (64, 32, 16)
SHAPE = (1, 100, 300, 1)


@pytest.mark.parametrize("d", WIDTHS)
def test_plain_fp32_versions_match_jax_and_the_tf32_mutant_does_not(d):
    q, k, v, g = _inputs(d, *SHAPE, d)
    j_out, j_lse, j_grads = _jax_fwd_and_grads(q, k, v, g)
    scale, bkv = d ** -0.5, tfa.FP32_BLOCK_KV[d]
    q3, k3, v3, g3 = (_to3d(x) for x in (q, k, v, g))
    jo3 = _to3d(j_out)

    # the standard forward: the natural domain, the fp32 default
    o, lse = tfa.flash_fwd_tiled_reference(q3, k3, v3, scale, bkv)
    assert o.dtype == lse.dtype == torch.float32
    assert torch.equal(o, tfa.flash_fwd_tiled_reference(
        q3, k3, v3, scale, bkv, "natural")[0])
    assert _rel_l2(o, jo3) <= REL_L2
    assert np.abs(lse.numpy() - j_lse).max() <= LSE_ABS
    # the wrapper's CPU route (the one-pass plain version) agrees too
    wo, wlse = tfa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    assert _rel_l2(wo, j_out) <= REL_L2
    assert np.abs(wlse.numpy() - j_lse).max() <= LSE_ABS

    # the backward: p = exp(s * scale - lse), fp32 p and ds
    grads = tfa.flash_bwd_tiled_reference(q3, k3, v3, o, lse, g3, scale, bkv)
    for name, mine, ref in zip(("dq", "dk", "dv"), grads, j_grads):
        assert _rel_l2(mine, _to3d(ref)) <= REL_L2, name

    # every product's operands rounded to TF32: about 1e-3, refused
    mo, _ = tfa.flash_fwd_tiled_reference(q3, k3, v3, scale, bkv, tf32=True)
    assert _rel_l2(mo, jo3) > 10 * REL_L2
    mgrads = tfa.flash_bwd_tiled_reference(q3, k3, v3, o, lse, g3, scale, bkv,
                                           tf32=True)
    for name, mine, ref in zip(("dq", "dk", "dv"), mgrads, j_grads):
        assert _rel_l2(mine, _to3d(ref)) > 10 * REL_L2, name


@pytest.mark.parametrize("d", WIDTHS)
def test_plain_fp32_deferred_forward_matches_jax_pipelined_kernel(d):
    q, k, v, _ = (_to3d(x) for x in _inputs(d + 1, 1, 128, 256, 1, d))
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jfa._flash_fwd_3d_pipelined(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)), scale, 128, 128)
    jlse = np.asarray(jlse)[..., 0]
    o, lse = tfa.flash_fwd_pipelined_reference(q, k, v, scale,
                                               tfa.FP32_BLOCK_KV[d])
    # fp32: q prescaled by scale * log2 e, base 2, as JAX's deferred kernel
    assert torch.equal(o, tfa.flash_fwd_tiled_reference(
        q, k, v, scale, tfa.FP32_BLOCK_KV[d], "prescaled")[0])
    assert _rel_l2(o, jo) <= REL_L2
    assert np.abs(lse.numpy() - jlse).max() <= LSE_ABS
    # the natural domain on prescaled q (exp of base-2 scores) is refused
    bad = tfa.flash_fwd_tiled_reference(
        (q * (scale * tfa._LOG2E)), k, v, 1.0, tfa.FP32_BLOCK_KV[d],
        "natural")
    assert (_rel_l2(bad[0], jo) > 10 * REL_L2
            or np.abs(bad[1].numpy() - jlse).max() > LSE_ABS)
    mo, _ = tfa.flash_fwd_pipelined_reference(q, k, v, scale,
                                              tfa.FP32_BLOCK_KV[d], tf32=True)
    assert _rel_l2(mo, jo) > 10 * REL_L2


@pytest.mark.parametrize("d", WIDTHS)
def test_the_other_mutants_fail_the_bound(d):
    q, k, v, g = (_to3d(x) for x in _inputs(7, 1, 64, 160, 1, d))
    scale, bkv = d ** -0.5, tfa.FP32_BLOCK_KV[d]
    o, lse = tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv)
    # the LSE left in base 2
    assert (lse / tfa._LN2 - lse).abs().max().item() > LSE_ABS
    # the last kv tile never consumed
    cut = k.shape[1] - bkv
    mo, mlse = tfa.flash_fwd_tiled_reference(q, k[:, :cut], v[:, :cut],
                                             scale, bkv)
    assert _rel_l2(mo, o) > REL_L2 and (mlse - lse).abs().max() > LSE_ABS
    # dk x (1 + 1e-4)
    dk = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)[1]
    assert _rel_l2(dk * (1 + 1e-4), dk) > REL_L2


@pytest.mark.parametrize("d", WIDTHS)
def test_wrappers_take_fp32_at_every_width(d):
    q, k, v, o, do = (torch.empty((2, n, 3, d), device="meta")
                      for n in (128, 256, 256, 128, 128))
    lse = torch.empty((6, 128), device="meta")
    # fp32 passes every check but the device's
    for call in (lambda: tfa.flash_fwd(q, k, v, d ** -0.5),
                 lambda: tfa.flash_bwd_dq(q, k, v, o, lse, do, d ** -0.5),
                 lambda: tfa.flash_bwd_dkv(q, k, v, do, lse, lse, d ** -0.5)):
        with pytest.raises(ValueError, match="runs on cuda or cpu, not meta"):
            call()


@pytest.mark.parametrize("dtypes,match", [
    ((torch.float16,) * 3, "take bf16 or fp32"),
    ((torch.float32, torch.bfloat16, torch.float32), "take one dtype"),
    ((torch.bfloat16, torch.bfloat16, torch.float32), "take one dtype")])
def test_wrappers_refuse_fp16_and_mixed_dtypes(dtypes, match):
    q, k, v = (torch.empty((1, 256, 1, 64), device="meta", dtype=dt)
               for dt in dtypes)
    with pytest.raises(ValueError, match=match):
        tfa.flash_fwd(q, k, v, 0.125)
    with pytest.raises(ValueError, match=r"D in \(64, 256, 512\)"):
        tfa.flash_fwd(*(torch.empty((1, 256, 1, 128), device="meta")
                        for _ in range(3)), 0.125)


def test_layout_check_counts_16_bytes_by_element_size():
    # rows of 68 elements: 272 bytes in fp32 (17 x 16), 136 in bf16
    tfa.check_tma_layout(torch.zeros((2, 8, 2, 68))[..., :64], "q")
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        tfa.check_tma_layout(
            torch.zeros((2, 8, 2, 68), dtype=torch.bfloat16)[..., :64], "q")
    # rows of 66 fp32 elements: 264 bytes
    with pytest.raises(ValueError, match="multiples of 4 elements"):
        tfa.check_tma_layout(torch.zeros((2, 8, 2, 66))[..., :64], "q")
    # what the models hand over: (B, S, H*D) projections and packed ones
    for d, h in ((64, 5), (256, 1), (512, 1)):
        tfa.check_tma_layout(torch.zeros((2, 16, h * d)).view(2, 16, h, d))
        tfa.check_tma_layout(torch.zeros((2, 16, 3, h, d))[:, :, 1])


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_entry_names_and_counters(d, dtype):
    wide = "" if d == 64 else f"_d{d}"
    sfx = "_fp32" if dtype == torch.float32 else "_bf16"
    pre = ("fp32_" if dtype == torch.float32 else "") + wide[1:] + (
        "_" if wide else "")
    assert [tfa.kernel_name(kind, d, dtype) for kind in KINDS] == [
        f"flash_fwd{wide}{sfx}", f"flash_fwd_pipelined{wide}{sfx}",
        f"flash_bwd_dq{wide}{sfx}", f"flash_bwd_dkv{wide}{sfx}"]
    assert [tfa.counter_name(kind, d, dtype) for kind in KINDS] == [
        f"{pre}launches", f"{pre}pipelined_launches",
        f"{pre}bwd_dq_launches", f"{pre}bwd_dkv_launches"]
    signatures = _build._signatures()
    every = [tfa.counter_name(kind, w, dt) for kind in KINDS for w in WIDTHS
             for dt in (torch.bfloat16, torch.float32)]
    assert len(set(every)) == 24
    for kind in KINDS:
        assert tfa.kernel_name(kind, d, dtype) in signatures
    # a forward on (dtype, width, switch) counts in its own counter only
    q, k = (torch.empty((1, n, 1, d), device="meta", dtype=dtype)
            for n in (64, 4096))
    for pipelined in (False, True):
        before = {n: getattr(tfa.flash_attention, n) for n in every}
        tfa._count_forward(q, k, pipelined)
        counter = tfa.counter_name("fwd_pipelined" if pipelined else "fwd", d,
                                   dtype)
        assert {n: getattr(tfa.flash_attention, n) - before[n]
                for n in every} == {n: int(n == counter) for n in every}


def test_device_numerics_take_fp32_flash_models():
    fp32 = (UNetConfig(use_flash_attention=True),
            VAEConfig(use_flash_attention=True))
    assert all(c.dtype == torch.float32 for c in fp32)
    configure_cuda_numerics(torch.device("cuda"), *fp32)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    configure_cuda_numerics(torch.device("cuda"),
                            UNetConfig(use_flash_attention=True,
                                       dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="take bf16 or fp32"):
        configure_cuda_numerics(torch.device("cuda"),
                                VAEConfig(use_flash_attention=True,
                                          dtype=torch.float16))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")


def _held(got, ref) -> bool:
    return _rel_l2(got.cpu(), ref.cpu()) <= REL_L2


# (B*H, S, T): a training step's shape at each width and a ragged one
CUDA_SHAPES = {64: [(20, 4096, 4096), (4, 1000, 577)],
               256: [(16, 4096, 4096), (2, 1000, 1500)],
               512: [(4, 4096, 4096), (2, 1000, 1500)]}


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t,d", [(*c, d) for d in WIDTHS
                                      for c in CUDA_SHAPES[d]])
def test_cuda_fp32_kernels_match_plain(bh, s, t, d):
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, g = (torch.randn((bh, n, d), generator=gen, device="cuda")
                  for n in (s, t, t, s))
    scale, bkv = d ** -0.5, tfa.FP32_BLOCK_KV[d]
    counters = [tfa.counter_name(kind, d, torch.float32) for kind in KINDS]
    before = [getattr(tfa.flash_attention, n) for n in counters]
    o, lse = tfa.flash_fwd_3d(q, k, v, scale)
    dq, delta = tfa.flash_bwd_dq_3d(q, k, v, o, lse, g, scale)
    dk, dv = tfa.flash_bwd_dkv_3d(q, k, v, g, lse, delta, scale)
    again = (*tfa.flash_fwd_3d(q, k, v, scale),
             *tfa.flash_bwd_dq_3d(q, k, v, o, lse, g, scale),
             *tfa.flash_bwd_dkv_3d(q, k, v, g, lse, delta, scale))
    torch.cuda.synchronize()
    assert [getattr(tfa.flash_attention, n) - b
            for n, b in zip(counters, before)] == [2, 0, 2, 2]
    assert all(torch.equal(a, b)
               for a, b in zip((o, lse, dq, delta, dk, dv), again))
    ro, rlse = tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv)
    assert _held(o, ro) and (lse - rlse).abs().max().item() <= LSE_ABS
    ref = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)
    for name, mine, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert _held(mine, r), name
    # the TF32 mutant and dk x (1 + 1e-4) fail the bound
    assert not _held(tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv,
                                                   tf32=True)[0], ro)
    assert not _held(ref[1] * (1 + 1e-4), ref[1])
    if tfa._pipelined_takes(t, d):
        po, plse = tfa.flash_fwd_3d_pipelined(q, k, v, scale)
        po2, _ = tfa.flash_fwd_3d_pipelined(q, k, v, scale)
        torch.cuda.synchronize()
        pref = tfa.flash_fwd_pipelined_reference(q, k, v, scale, bkv)
        assert torch.equal(po, po2) and _held(po, pref[0])
        assert (plse - pref[1]).abs().max().item() <= LSE_ABS


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_fp32_strided_views_give_the_contiguous_bits(d):
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    h = 5 if d == 64 else 1
    x = torch.randn((2, 1024, 4, h, d), generator=gen, device="cuda")
    q, k, v, g = (x[:, :, i] for i in range(4))
    scale = d ** -0.5
    o, lse = tfa.flash_fwd(q, k, v, scale)
    grads = tfa.flash_bwd(q, k, v, o, lse, g, scale)
    flat = [y.contiguous() for y in (q, k, v, g)]
    o2, lse2 = tfa.flash_fwd(*flat[:3], scale)
    grads2 = tfa.flash_bwd(*flat[:3], o2, lse2, flat[3], scale)
    torch.cuda.synchronize()
    assert o.is_contiguous() and torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(a.is_contiguous() and torch.equal(a, b)
               for a, b in zip(grads, grads2))


@pytest.mark.cuda
def test_cuda_fp16_raises_and_launches_nothing():
    _skip_without_card()
    q = torch.zeros((1, 1024, 1, 64), device="cuda", dtype=torch.float16)
    every = [tfa.counter_name(kind, w, dt) for kind in KINDS for w in WIDTHS
             for dt in (torch.bfloat16, torch.float32)]
    before = [getattr(tfa.flash_attention, n) for n in every]
    with pytest.raises(ValueError, match="take bf16 or fp32"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="take one dtype"):
        tfa.flash_attention(q.float(), q.float(), q.bfloat16())
    assert before == [getattr(tfa.flash_attention, n) for n in every]
