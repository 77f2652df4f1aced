"""PyTorch port, flash-attention backward: ``FlashAttentionFn`` on the CPU
(plain forward + ``flash_bwd_reference``) against ``jax.grad`` through the
JAX package's custom-VJP flash attention (Pallas backward kernels in
interpret mode, as tests/test_flash_attention.py runs them), and the plain
backward against torch autograd through the dense path.

The CUDA kernels themselves run only on a card: their tests are marked
``cuda`` and skip elsewhere.
"""

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
    flash_bwd_3d,
    flash_bwd_reference,
    flash_fwd_3d,
)

# fp32 on both sides; the two differ only in summation order (the Pallas
# kernels sum per block), so 2e-5 on gradients of at most unit scale leaves
# over 20x headroom over what was seen (8.3e-7 at worst)
ATOL = 2e-5


def _inputs(seed, b, s, t, h, d=64):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d),
                               (b, s, h, d)))


@pytest.mark.parametrize("b,s,t,h", [(1, 1024, 1024, 2), (2, 200, 77, 2),
                                     (1, 300, 577, 2)])
def test_flash_backward_matches_jax_custom_vjp(b, s, t, h):
    q, k, v, g = _inputs(0, b, s, t, h)
    j_grads = jax.grad(
        lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v) * g),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
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


# bf16 kernels against the plain fp32 algorithm on the same bf16 inputs:
# outputs are rounded to bf16 (half an ulp of x is at most |x| * 2^-8) and p,
# ds are rounded to bf16 before the second products.  The gradients shrink
# with the number of keys (max |ref| is 0.3 to 0.4 at 4096), so the max abs
# bound is BWD_HALF_ULPS half-ulps of max |ref| at each shape (1 to 2 seen),
# and the relative L2 error of each gradient stays within TOL_BWD_REL_L2
# (about 3e-3 seen; a skipped kv tile or a dropped delta term gives over 2e-2)
BWD_HALF_ULPS, TOL_BWD_REL_L2 = 3, 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t", [(20, 4096, 4096), (40, 1024, 1024),
                                    (4, 1000, 577), (3, 70, 130)])
def test_cuda_backward_kernels_match_plain(bh, s, t):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn((bh, n, 64), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for n in (s, t, t, s))
    o, lse = flash_fwd_3d(q, k, v, 0.125)
    before = (flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches)
    got = flash_bwd_3d(q, k, v, o, lse, g, 0.125)
    torch.cuda.synchronize()
    assert (flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches) == (before[0] + 1, before[1] + 1)
    for name, mine, ref in zip(("dq", "dk", "dv"), got,
                               flash_bwd_reference(q, k, v, o, lse, g, 0.125)):
        diff, ref = mine.float() - ref.float(), ref.float()
        tol = BWD_HALF_ULPS * ref.abs().max().item() * 2.0 ** -8
        assert diff.abs().max().item() <= tol, f"{name}: max abs over {tol}"
        rel = (diff.norm() / ref.norm()).item()
        assert rel <= TOL_BWD_REL_L2, f"{name}: relative L2 {rel}"
    # no atomics in either kernel: a second call gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(
        got, flash_bwd_3d(q, k, v, o, lse, g, 0.125)))
    with pytest.raises(ValueError):  # no fallback for what the kernels refuse
        flash_bwd_3d(q.float(), k.float(), v.float(), o.float(), lse,
                     g.float(), 0.125)


@pytest.mark.cuda
def test_cuda_autograd_function_runs_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 1024, 5, 64), generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    g = torch.randn((2, 1024, 5, 64), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    flash_attention(q, k, v).backward(g)
    q3, k3, v3 = _to3d(q.detach()), _to3d(k.detach()), _to3d(v.detach())
    o3, lse = flash_fwd_3d(q3, k3, v3, 0.125)
    for leaf, ref in zip((q, k, v),
                         flash_bwd_3d(q3, k3, v3, o3, lse, _to3d(g), 0.125)):
        assert torch.equal(_to3d(leaf.grad), ref)
