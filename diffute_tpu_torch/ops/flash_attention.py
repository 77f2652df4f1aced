"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``diffute_tpu/ops/flash_attention.py``: the forward
(``_flash_fwd_3d`` + ``_fwd_kernel`` -> ``csrc/flash_fwd.cu``), the
deferred-softmax forward behind the ``PIPELINE_FWD`` switch
(``_flash_fwd_3d_pipelined`` + ``_fwd_kernel_pipelined`` ->
``csrc/flash_fwd_pipelined.cu``) and the
backward (``_flash_bwd_3d`` + ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` ->
``csrc/flash_bwd.cu``), joined by :class:`FlashAttentionFn` as the JAX
package joins them with ``jax.custom_vjp``.  The forwards read bf16 q, k, v
of head_dim 64 through their strides (TMA), so the serving path hands them
the (batch, seq, heads, head_dim) views it has and gets o back in that
layout, contiguous; the backward kernels take contiguous
(batch*heads, seq, 64) copies.  Every LSE is natural-log fp32
(batch*heads, seq).

On a CUDA tensor every wrapper launches its kernel or raises; none falls
back.  On a CPU tensor it computes the plain version, which is what the CPU
tests compare against the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# Route forwards whose kv length is a whole number (>= 2) of kv tiles through
# the deferred-softmax kernel.  Module-level, off by default, as in the JAX
# package: the switch exists so the two forwards can be timed in turns.
PIPELINE_FWD = False
# the kv tile of csrc/flash_fwd_pipelined.cu
PIPELINED_BLOCK_KV = 64
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def set_pipeline_fwd(on: bool) -> bool:
    """Set ``PIPELINE_FWD``; return what it was.  (``diffute_tpu_torch.ops``
    exports the function ``flash_attention`` under this module's name, so
    ``ops.flash_attention.PIPELINE_FWD = ...`` would miss the module.)"""
    global PIPELINE_FWD
    was, PIPELINE_FWD = PIPELINE_FWD, bool(on)
    return was


def _to3d(x: torch.Tensor) -> torch.Tensor:
    # (B, S, H, D) -> contiguous (B*H, S, D): a copy, which only
    # FlashAttentionFn makes now (the backward kernels take contiguous 3-D
    # input); the forwards read the 4-D views through their strides.
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def _from3d(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 version of the kernel's contract.

    q (BH, S, D), k/v (BH, T, D) -> (o (BH, S, D) in q's dtype,
    lse (BH, S) fp32, natural log)."""
    logits = torch.einsum("bsd,btd->bst", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bst,btd->bsd", p, v.float())
    return o.to(q.dtype), lse


def flash_fwd_tiled_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float,
                              block_kv: int = PIPELINED_BLOCK_KV
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of both forward kernels' arithmetic, kv tile by kv
    tile: fp32 score tiles in base 2 (``q k^T * scale * log2 e``, scaled
    after the product as the kernels' FMA does), running max and sum, ``p``
    rounded to ``v``'s dtype before ``p v``, and the LSE converted to
    natural log at the end.  Any T: the last tile may be short (the kernels
    mask its columns past T).  The kernels round ``p`` against the running
    max, so this, not the one-pass :func:`flash_attention_reference`, is
    what they match to a few bf16 ulps.

    q (BH, S, D), k/v (BH, T, D) -> (o (BH, S, D) in q's dtype,
    lse (BH, S) fp32)."""
    bh, s_len, d = q.shape
    qf, c = q.float(), scale * _LOG2E
    m = torch.full((bh, s_len, 1), -torch.inf, device=q.device)
    l = torch.zeros((bh, s_len, 1), device=q.device)
    acc = torch.zeros((bh, s_len, d), device=q.device)
    for j in range(0, k.shape[1], block_kv):
        s_j = torch.einsum("bsd,btd->bst", qf,
                           k[:, j:j + block_kv].float()) * c
        m_new = torch.maximum(m, s_j.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s_j - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bst,btd->bsd", p.to(v.dtype).float(),
            v[:, j:j + block_kv].float())
        m = m_new
    lse = (m + torch.log2(l)) * _LN2
    return (acc / l).to(q.dtype), lse[..., 0]


def flash_fwd_pipelined_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, scale: float,
                                  block_kv: int = PIPELINED_BLOCK_KV
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the deferred-softmax kernel.  The kernel issues tile
    ``j + 1``'s scores before tile ``j``'s softmax, which reorders the work
    and not the arithmetic: :func:`flash_fwd_tiled_reference`, restricted to
    the dispatch rule's T.

    q (BH, S, D), k/v (BH, T, D) with T a multiple of ``block_kv`` and at
    least two tiles -> (o (BH, S, D) in q's dtype, lse (BH, S) fp32)."""
    t_len = k.shape[1]
    if t_len % block_kv or t_len // block_kv < 2:
        raise ValueError(f"the pipelined forward takes T a multiple of "
                         f"{block_kv} with at least two tiles; got {t_len}")
    return flash_fwd_tiled_reference(q, k, v, scale, block_kv)


def check_tma_layout(x: torch.Tensor, name: str = "x") -> None:
    """Raise on a layout the forwards' TMA loads cannot read: a last
    (head_dim) stride other than 1, another stride not a multiple of 8
    elements (16 bytes of bf16), or a base not 16-byte aligned.  Nothing is
    copied to make a layout fit."""
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the last stride must be 1, got "
                         f"{x.stride()}")
    if any(st % 8 for st in x.stride()[:-1]):
        raise ValueError(f"{name}: strides {x.stride()} are not multiples of "
                         f"8 elements")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: base address is not 16-byte aligned")


def _check_kernel_inputs(ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: every tensor on ``ref``'s
    CUDA device, bf16, (BH, seq, 64), contiguous and 16-byte aligned."""
    if ref.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {ref.device}")
    for name, x in tensors.items():
        if x.device != ref.device:
            raise ValueError(f"{name} is on {x.device}, q on {ref.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"the flash kernel takes bf16; {name} is {x.dtype}")
        if x.dim() != 3 or x.shape[-1] != 64:
            raise ValueError(f"the flash kernel takes (BH, seq, 64); "
                             f"{name} is {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    q, k, v = tensors["q"], tensors["k"], tensors["v"]
    if (k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[1] == 0
            or q.shape[1] == 0):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def _launch(name: str, *args) -> None:
    from diffute_tpu_torch.ops import _build

    err = getattr(_build.load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, pipelined: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a forward kernel on (B, S, H, 64) q and (B, T, H, 64) k, v as
    they lie: o comes back contiguous (B, S, H, 64), lse (B*H, S).  Raises
    on anything the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.bfloat16:
            raise ValueError(f"the flash kernel takes bf16 on {q.device}; "
                             f"{name} is {x.dtype} on {x.device}")
        if x.dim() != 4 or x.shape[-1] != 64:
            raise ValueError(f"the flash kernel takes (B, seq, H, 64); "
                             f"{name} is {tuple(x.shape)}")
        check_tma_layout(x, name)
    b, s_len, h, _ = q.shape
    t_len = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != h
            or s_len == 0 or t_len == 0):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if pipelined and not _pipelined_takes(t_len):
        raise ValueError(f"the pipelined forward takes T a multiple of "
                         f"{PIPELINED_BLOCK_KV} with at least two tiles; "
                         f"got {t_len}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b * h, s_len), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(st for x in (q, k, v, o)
                                         for st in x.stride()[:3]))
    name = "flash_fwd_pipelined_bf16" if pipelined else "flash_fwd_bf16"
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, s_len, t_len, strides, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if pipelined:
        flash_attention.pipelined_launches += 1
    else:
        flash_attention.launches += 1
    flash_attention.flops += 4 * b * h * s_len * t_len * 64
    return o, lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, H, 64), k/v (B, T, H, 64) in any layout TMA reads
    (:func:`check_tma_layout`) -> (o (B, S, H, 64) contiguous,
    lse (B*H, S)).  No copy of q, k or v is made.

    CUDA: the kernel on the current stream (the deferred-softmax one with
    ``PIPELINE_FWD`` set and T a whole number (>= 2) of kv tiles).  CPU:
    the matching plain version."""
    pipelined = PIPELINE_FWD and _pipelined_takes(k.shape[1])
    if q.device.type != "cpu":
        return _fwd_kernel(q, k, v, scale, pipelined)
    b, s_len, h, d = q.shape
    ref = (flash_fwd_pipelined_reference if pipelined
           else flash_attention_reference)
    o3, lse = ref(*(x.transpose(1, 2).flatten(0, 1) for x in (q, k, v)),
                  scale)
    return o3.view(b, h, s_len, d).transpose(1, 2).contiguous(), lse


def flash_fwd_3d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (BH, S, 64), k/v (BH, T, 64) -> (o (BH, S, 64), lse (BH, S)):
    :func:`flash_fwd` with H = 1, so the same dispatch (``PIPELINE_FWD``)
    and the same checks (raises on anything the kernel does not take)."""
    o, lse = flash_fwd(*_as4d(q, k, v), scale)
    return o[:, :, 0], lse


def _as4d(*xs: torch.Tensor):
    for x in xs:
        if x.dim() != 3:
            raise ValueError(f"expected (BH, seq, 64), got {tuple(x.shape)}")
    return tuple(x[:, :, None] for x in xs)


def _pipelined_takes(t_len: int) -> bool:
    return (t_len % PIPELINED_BLOCK_KV == 0
            and t_len // PIPELINED_BLOCK_KV >= 2)


def flash_fwd_3d_pipelined(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_fwd_3d`'s contract through the deferred-softmax kernel;
    T must be a multiple of the kv tile with at least two tiles (raises
    otherwise: nothing is padded).

    CUDA: checks and launches the kernel on the current stream.  CPU: its
    plain version."""
    if q.device.type == "cpu":
        return flash_fwd_pipelined_reference(q, k, v, scale)
    o, lse = _fwd_kernel(*_as4d(q, k, v), scale, pipelined=True)
    return o[:, :, 0], lse


def _scores(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
            scale: float) -> torch.Tensor:
    """p = exp(q k^T * scale - lse), fp32 (BH, S, T): the softmax recomputed
    from the saved LSE."""
    logits = torch.einsum("bsd,btd->bst", q.float(), k.float()) * scale
    return torch.exp(logits - lse[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale) -> torch.Tensor:
    """Plain fp32 version of the dq kernel: ds = p * (dO v^T - delta),
    dq = ds k * scale, in q's dtype."""
    dp = torch.einsum("bsd,btd->bst", do.float(), v.float())
    ds = _scores(q, k, lse, scale) * (dp - delta[..., None])
    return (torch.einsum("bst,btd->bsd", ds, k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 version of the dk/dv kernel: dv = p^T dO,
    dk = ds^T q * scale, in k's and v's dtypes."""
    p = _scores(q, k, lse, scale)
    dof = do.float()
    dv = torch.einsum("bst,bsd->btd", p, dof)
    ds = p * (torch.einsum("bsd,btd->bst", dof, v.float()) - delta[..., None])
    dk = torch.einsum("bst,bsd->btd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32, (BH, S): computed outside the kernels, as the
    JAX package does."""
    return (do.float() * o.float()).sum(-1)


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain fp32 version of the backward kernels' algorithm (not autograd
    through the forward): p recomputed from the saved LSE.

    q, o, do (BH, S, D), k/v (BH, T, D), lse (BH, S) -> (dq, dk, dv) in the
    inputs' dtypes."""
    delta = _delta(o, do)
    return (flash_bwd_dq_reference(q, k, v, do, lse, delta, scale),
            *flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale))


def _bwd_kernel_args(q, k, v, do, lse, delta, scale):
    """Check the backward kernels' common inputs; return their C arguments
    before and after the output pointers."""
    _check_kernel_inputs(q, q=q, k=k, v=v, do=do)
    bh, s_len, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (bh, s_len) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 ({bh}, {s_len}) "
                             f"on {q.device}; got {x.dtype} {tuple(x.shape)}")
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (bh, s_len, k.shape[1], float(scale),
             torch.cuda.current_stream(q.device).cuda_stream))


def flash_bwd_dq_3d(q, k, v, do, lse, delta, scale) -> torch.Tensor:
    """dq (BH, S, 64) from the saved LSE and delta.  CUDA: checks and
    launches the dq kernel on the current stream.  CPU: the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    ins, dims = _bwd_kernel_args(q, k, v, do, lse, delta, scale)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq_bf16", *ins, dq.data_ptr(), *dims)
    flash_attention.bwd_dq_launches += 1
    return dq


def flash_bwd_dkv_3d(q, k, v, do, lse, delta, scale
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv (BH, T, 64) from the saved LSE and delta.  CUDA: checks and
    launches the dk/dv kernel on the current stream.  CPU: the plain
    version."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    ins, dims = _bwd_kernel_args(q, k, v, do, lse, delta, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv_bf16", *ins, dk.data_ptr(), dv.data_ptr(), *dims)
    flash_attention.bwd_dkv_launches += 1
    return dk, dv


def flash_bwd_3d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_fwd_3d`'s ``o`` w.r.t. q, k, v, from the
    forward's saved ``o`` and ``lse`` and the incoming ``do``: delta in plain
    torch, then the dq and the dk/dv kernel (CPU: their plain versions)."""
    if o.shape != do.shape or o.dtype != do.dtype or o.device != do.device:
        raise ValueError(f"o ({o.dtype} {tuple(o.shape)} on {o.device}) and do "
                         f"({do.dtype} {tuple(do.shape)} on {do.device}) differ")
    delta = _delta(o, do)
    return (flash_bwd_dq_3d(q, k, v, do, lse, delta, scale),
            *flash_bwd_dkv_3d(q, k, v, do, lse, delta, scale))


class FlashAttentionFn(torch.autograd.Function):
    """(B, S, H, D) attention whose forward and backward are the kernels.

    The forward saves the 3-D copies it made for the kernel with ``o`` and
    the LSE, so the backward re-derives none of them from the 4-D inputs."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        b, _, h, _ = q.shape
        q3, k3, v3 = _to3d(q), _to3d(k), _to3d(v)
        o3, lse = flash_fwd_3d(q3, k3, v3, scale)
        ctx.save_for_backward(q3, k3, v3, o3, lse)
        ctx.scale, ctx.bh = scale, (b, h)
        return _from3d(o3, b, h)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q3, k3, v3, o3, lse = ctx.saved_tensors
        dq3, dk3, dv3 = flash_bwd_3d(q3, k3, v3, o3, lse, _to3d(grad_out),
                                     ctx.scale)
        return (*(_from3d(x, *ctx.bh) for x in (dq3, dk3, dv3)), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over (batch, seq, heads, head_dim) tensors,
    differentiable in q, k and v.

    Kernel launches are counted (CUDA only): ``flash_attention.launches``
    the forward, ``.pipelined_launches`` the deferred-softmax forward,
    ``.bwd_dq_launches`` and ``.bwd_dkv_launches`` the two backward
    kernels."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        # nothing to differentiate (serving, the frozen encoders): the
        # forward alone on the 4-D views, no copy in and o contiguous out
        # (so the caller's reshape to (B, S, H*D) is a view)
        return flash_fwd(q, k, v, scale)[0]
    return FlashAttentionFn.apply(q, k, v, scale)


flash_attention.launches = 0
flash_attention.pipelined_launches = 0
# matrix-product FLOPs of the forward launches (edit_profiled reads it)
flash_attention.flops = 0
flash_attention.bwd_dq_launches = 0
flash_attention.bwd_dkv_launches = 0
