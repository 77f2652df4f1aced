"""PyTorch port, flash-attention backward: ``FlashAttentionFn`` on the CPU
(plain forward + ``flash_bwd_reference``) against ``jax.grad`` through the
JAX package's custom-VJP flash attention (Pallas backward kernels in
interpret mode, as tests/test_flash_attention.py runs them), the plain
backward against torch autograd through the dense path, and the kernels'
tile-by-tile plain version (``flash_bwd_tiled_reference``) against both.

The CUDA kernels themselves run only on a card: their tests are marked
``cuda`` and skip elsewhere.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffute_tpu.ops.flash_attention as jfa

from diffute_tpu_torch.ops import dense_attention, flash_attention
from diffute_tpu_torch.ops.flash_attention import (
    FlashAttentionFn,
    _to3d,
    flash_attention_reference,
    flash_bwd,
    flash_bwd_3d,
    flash_bwd_reference,
    flash_bwd_tiled_reference,
    flash_fwd,
    flash_fwd_3d,
)

tfa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")

# fp32 on both sides; the two differ only in summation order (the Pallas
# kernels sum per block), so 2e-5 on gradients of at most unit scale leaves
# over 20x headroom over what was seen (8.3e-7 at worst)
ATOL = 2e-5


def _inputs(seed, b, s, t, h, d=64):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d),
                               (b, s, h, d)))


@functools.lru_cache(maxsize=None)
def _jax_grads(b, s, t, h):
    """jax.grad of sum(flash_attention(q, k, v) * g) on _inputs(0, ...)."""
    q, k, v, g = _inputs(0, b, s, t, h)
    return tuple(np.array(x) for x in jax.grad(
        lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v) * g),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


JAX_SHAPES = [(1, 1024, 1024, 2), (2, 200, 77, 2), (1, 300, 577, 2)]


@pytest.mark.parametrize("b,s,t,h", JAX_SHAPES)
def test_flash_backward_matches_jax_custom_vjp(b, s, t, h):
    q, k, v, g = _inputs(0, b, s, t, h)
    j_grads = _jax_grads(b, s, t, h)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv)  # CPU tensors: the plain versions
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith(
        FlashAttentionFn.__name__)
    out.backward(torch.from_numpy(g))
    for name, mine, ref in zip("qkv", (tq, tk, tv), j_grads):
        np.testing.assert_allclose(mine.grad.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("b,s,t,h", [(2, 96, 96, 3), (1, 130, 70, 2)])
def test_plain_backward_matches_autograd_through_dense(b, s, t, h):
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, b, s, t, h))
    scale = 64 ** -0.5
    q3, k3, v3, g3 = _to3d(q), _to3d(k), _to3d(v), _to3d(g)
    o3, lse = flash_attention_reference(q3, k3, v3, scale)
    got = flash_bwd_reference(q3, k3, v3, o3, lse, g3, scale)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    dense_attention(*leaves, scale).backward(g)
    for name, mine, leaf in zip("qkv", got, leaves):
        np.testing.assert_allclose(mine.numpy(), _to3d(leaf.grad).numpy(),
                                   atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_backward_wrapper_on_cpu_launches_nothing_and_checks_devices():
    q, k, v, g = (_to3d(torch.from_numpy(x)) for x in _inputs(2, 1, 8, 8, 1))
    o, lse = flash_fwd_3d(q, k, v, 0.125)
    before = (flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches)
    dq, dk, dv = flash_bwd_3d(q, k, v, o, lse, g, 0.125)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert before == (flash_attention.bwd_dq_launches,
                      flash_attention.bwd_dkv_launches)
    m = torch.zeros((1, 4, 64), device="meta")
    with pytest.raises(ValueError):  # neither cuda nor cpu: raise, no fallback
        flash_bwd_3d(m, m, m, m, torch.zeros((1, 4), device="meta"), m, 0.125)


def test_inference_mode_records_no_graph():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3, 1, 16, 16, 1))
    with torch.inference_mode():
        out = flash_attention(q, k, v)
    assert not out.requires_grad
    np.testing.assert_allclose(
        out.numpy(), dense_attention(q, k, v, 0.125).numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("leaves_require_grad", [False, True])
def test_without_grad_no_autograd_node_is_made(leaves_require_grad,
                                               monkeypatch):
    # serving and the frozen encoders: the forward wrapper alone
    q, k, v, _ = (torch.from_numpy(x).requires_grad_(leaves_require_grad)
                  for x in _inputs(4, 1, 16, 16, 2))
    monkeypatch.setattr(FlashAttentionFn, "forward", None)  # must not be used
    if leaves_require_grad:
        with torch.no_grad():
            out = flash_attention(q, k, v)
    else:
        out = flash_attention(q, k, v)
    assert out.grad_fn is None and out.shape == q.shape
    np.testing.assert_allclose(
        out.numpy(), dense_attention(q.detach(), k.detach(), v.detach(),
                                     0.125).numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,s,t,h", JAX_SHAPES)
def test_tiled_plain_backward_matches_jax_custom_vjp(b, s, t, h):
    # fp32 inputs: the tiled version rounds nothing, so it is the same
    # algorithm kv tile by kv tile and holds to JAX's ATOL
    q, k, v, g = (_to3d(torch.from_numpy(x)) for x in _inputs(0, b, s, t, h))
    o, lse = flash_attention_reference(q, k, v, 64 ** -0.5)
    got = flash_bwd_tiled_reference(q, k, v, o, lse, g, 64 ** -0.5)
    for name, mine, ref in zip("qkv", got, _jax_grads(b, s, t, h)):
        np.testing.assert_allclose(
            mine.numpy(), _to3d(torch.from_numpy(ref)).numpy(), atol=ATOL,
            rtol=0, err_msg=f"d{name}")


# bf16: the tiled version rounds p and ds to bf16 before their products and
# the one-pass version rounds only its outputs; the two differ by about
# 2.6e-3 in relative L2 (measured on these inputs), within 5e-3
TILED_VS_ONE_PASS_REL_L2 = 5e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,t", [(2, 256, 256), (1, 300, 577),
                                    (3, 70, 130)])
def test_tiled_plain_backward_matches_one_pass(dtype, bh, s, t):
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in _inputs(5, 1, s, t, bh))
    q, k, v, g = (x[0].transpose(0, 1).contiguous() for x in (q, k, v, g))
    o, lse = flash_attention_reference(q, k, v, 0.125)
    got = flash_bwd_tiled_reference(q, k, v, o, lse, g, 0.125)
    ref = flash_bwd_reference(q, k, v, o, lse, g, 0.125)
    for name, mine, r in zip(("dq", "dk", "dv"), got, ref):
        assert mine.dtype == r.dtype == dtype and mine.shape == r.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(mine.numpy(), r.numpy(), atol=ATOL,
                                       rtol=0, err_msg=name)
        else:
            rel = _errors(mine, r)["rel_l2"]
            assert rel <= TILED_VS_ONE_PASS_REL_L2, f"{name}: {rel}"


def test_flash_attention_fn_makes_no_copies(monkeypatch):
    """The autograd function hands the kernels' wrappers the 4-D views it
    was given (here views of one packed projection), makes no _to3d copy,
    and its gradients come back contiguous (B, L, H, 64), equal to JAX's."""
    b, s, t, h = 2, 200, 200, 2
    q, k, v, g = _inputs(0, b, s, t, h)

    def no_copy(x):
        raise AssertionError("FlashAttentionFn copied through _to3d")

    monkeypatch.setattr(tfa, "_to3d", no_copy)
    packed = torch.from_numpy(np.stack([q, k, v], axis=2)).requires_grad_()
    tq, tk, tv = (packed[:, :, i] for i in range(3))
    grads = torch.autograd.grad(flash_attention(tq, tk, tv),
                                (tq, tk, tv), torch.from_numpy(g))
    for name, mine, ref in zip("qkv", grads, _jax_grads(b, s, t, h)):
        assert mine.shape == (b, s, h, 64) and mine.is_contiguous(), name
        np.testing.assert_allclose(mine.numpy(), ref, atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_flash_bwd_on_strided_views_equals_contiguous_route():
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.standard_normal(
        (2, 96, 4, 3, 64)).astype(np.float32))
    q, k, v, do = (x[:, :, i] for i in range(4))
    assert not q.is_contiguous()
    o, lse = flash_fwd(q, k, v, 0.125)
    got = flash_bwd(q, k, v, o, lse, do, 0.125)
    ref = flash_bwd(*(y.contiguous() for y in (q, k, v, o)), lse,
                    do.contiguous(), 0.125)
    for mine, r in zip(got, ref):
        assert mine.is_contiguous() and mine.shape == (2, 96, 3, 64)
        assert torch.equal(mine, r)


# bf16 kernels against their own arithmetic (flash_bwd_tiled_reference) on
# the same bf16 inputs: dq, dk, dv are fp32 results rounded once to bf16 on
# both sides (half an ulp of x is at most |x| * 2^-8), so the max abs bound is
# BWD_HALF_ULPS half-ulps of max |ref| at each shape (0.26 to 0.82 read on an
# H100), and the relative L2 error of each gradient stays within
# TOL_BWD_REL_L2 (9.6e-5 to 2.0e-4 read).  A gradient scaled by 0.99 reads
# 1.0e-2, dk with delta taken as 0 2.7e-2 and dq with its last kv tile
# dropped 0.127 at (20, 4096, 4096): each fails.  delta is an fp32 sum of 64
# products on both sides (2.4e-7 read).
BWD_HALF_ULPS, TOL_BWD_REL_L2, TOL_DELTA = 3, 1e-3, 1e-5


def _errors(got, ref):
    diff, ref = got.float() - ref.float(), ref.float()
    return {"max_abs": diff.abs().max().item(),
            "max_abs_tol": BWD_HALF_ULPS * ref.abs().max().item() * 2.0 ** -8,
            "rel_l2": (diff.norm() / ref.norm()).item()}


def _held(got, ref) -> bool:
    e = _errors(got, ref)
    return e["max_abs"] <= e["max_abs_tol"] and e["rel_l2"] <= TOL_BWD_REL_L2


def _mutants(q, k, v, o, lse, g, ref):
    """What the criterion must refuse: each gradient x 0.99, dq with its last
    kv tile dropped, dk with delta taken as 0."""
    dq, dk, dv = ref
    return {"dq_x0.99": (dq.float() * 0.99, dq),
            "dk_x0.99": (dk.float() * 0.99, dk),
            "dv_x0.99": (dv.float() * 0.99, dv),
            "dq_last_tile_dropped": (flash_bwd_tiled_reference(
                q, k[:, :-64], v[:, :-64], o, lse, g, 0.125)[0], dq),
            "dk_delta_zero": (flash_bwd_tiled_reference(
                q, k, v, torch.zeros_like(o), lse, g, 0.125)[1], dk)}


def test_mutants_fail_the_bounds():
    # bf16 at a small size on the CPU: the criterion the cuda tests and
    # chip_smoke.py hold the kernels to refuses every mutant
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn((2, n, 64), generator=gen).to(torch.bfloat16)
                  for n in (512, 512, 512, 512))
    o, lse = tfa.flash_fwd_tiled_reference(q, k, v, 0.125)
    ref = flash_bwd_tiled_reference(q, k, v, o, lse, g, 0.125)
    assert all(_held(r, r) for r in ref)
    for name, (mutant, r) in _mutants(q, k, v, o, lse, g, ref).items():
        assert not _held(mutant, r), name


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t", [(20, 4096, 4096), (40, 1024, 1024),
                                    (4, 1000, 577), (3, 70, 130)])
def test_cuda_backward_kernels_match_plain(bh, s, t):
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn((bh, n, 64), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for n in (s, t, t, s))
    o, lse = flash_fwd_3d(q, k, v, 0.125)
    before = (flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches)
    dq, delta = tfa.flash_bwd_dq_3d(q, k, v, o, lse, g, 0.125)
    dk, dv = tfa.flash_bwd_dkv_3d(q, k, v, g, lse, delta, 0.125)
    got = (dq, dk, dv)
    torch.cuda.synchronize()
    assert (flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches) == (before[0] + 1, before[1] + 1)
    assert (delta - tfa._delta(o, g)).abs().max().item() <= TOL_DELTA
    for name, mine, ref in zip(("dq", "dk", "dv"), got,
                               flash_bwd_tiled_reference(q, k, v, o, lse, g,
                                                         0.125)):
        assert _held(mine, ref), f"{name}: {_errors(mine, ref)}"
    # no atomics in either kernel: a second call gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(
        got, flash_bwd_3d(q, k, v, o, lse, g, 0.125)))
    with pytest.raises(ValueError):  # no fallback for what the kernels refuse
        flash_bwd_3d(q.half(), k.half(), v.half(), o.half(), lse,
                     g.half(), 0.125)


@pytest.mark.cuda
def test_cuda_mutants_fail_the_bounds():
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn((20, 4096, 64), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    o, lse = flash_fwd_3d(q, k, v, 0.125)
    ref = flash_bwd_tiled_reference(q, k, v, o, lse, g, 0.125)
    assert all(_held(a, r) for a, r in zip(
        flash_bwd_3d(q, k, v, o, lse, g, 0.125), ref))
    for name, (mutant, r) in _mutants(q, k, v, o, lse, g, ref).items():
        assert not _held(mutant, r), name


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["4d", "strided"])
def test_cuda_backward_reads_4d_and_strided_views(layout):
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    if layout == "4d":  # the training step's (B, H) = (4, 5)
        q, k, v, g = (torch.randn((4, 4096, 5, 64), generator=gen,
                                  device="cuda", dtype=torch.bfloat16)
                      for _ in range(4))
    else:  # q, k, v, dO as views of one packed (B, S, 4, H, 64) projection
        x = torch.randn((2, 4096, 4, 5, 64), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        q, k, v, g = (x[:, :, i] for i in range(4))
    o, lse = flash_fwd(q, k, v, 0.125)
    got = flash_bwd(q, k, v, o, lse, g, 0.125)
    torch.cuda.synchronize()
    ref = flash_bwd_tiled_reference(*(_to3d(x) for x in (q, k, v, o)), lse,
                                    _to3d(g), 0.125)
    for name, mine, r in zip(("dq", "dk", "dv"), got, ref):
        assert mine.is_contiguous() and mine.shape == q.shape
        assert _held(_to3d(mine), r), f"{name}: {_errors(_to3d(mine), r)}"
    if layout == "strided":  # the same bits as the contiguous route
        assert all(torch.equal(a, b) for a, b in zip(got, flash_bwd(
            *(x.contiguous() for x in (q, k, v, o)), lse, g.contiguous(),
            0.125)))


@pytest.mark.cuda
def test_cuda_autograd_function_runs_the_kernels():
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 1024, 5, 64), generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    g = torch.randn((2, 1024, 5, 64), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    flash_attention(q, k, v).backward(g)
    o, lse = flash_fwd(q.detach(), k.detach(), v.detach(), 0.125)
    for leaf, ref in zip((q, k, v), flash_bwd(q.detach(), k.detach(),
                                              v.detach(), o, lse, g, 0.125)):
        assert leaf.grad.is_contiguous() and torch.equal(leaf.grad, ref)
