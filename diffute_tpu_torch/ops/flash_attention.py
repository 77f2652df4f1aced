"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``diffute_tpu/ops/flash_attention.py``: the forward
(``_flash_fwd_3d`` + ``_fwd_kernel`` -> ``csrc/flash_fwd.cu``), the
deferred-softmax forward behind the ``PIPELINE_FWD`` switch
(``_flash_fwd_3d_pipelined`` + ``_fwd_kernel_pipelined`` ->
``csrc/flash_fwd_pipelined.cu``) and the
backward (``_flash_bwd_3d`` + ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` ->
``csrc/flash_bwd.cu``), joined by :class:`FlashAttentionFn` as the JAX
package joins them with ``jax.custom_vjp``.  Every kernel reads its bf16
(batch, seq, heads, 64) inputs through their strides (TMA), so the callers
hand them the views they have, and writes its outputs contiguous in that
layout: no copy is made in either direction.  Every LSE is natural-log fp32
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
    # (B, S, H, D) -> contiguous (B*H, S, D): a copy, which the tests make to
    # compare with the 3-D plain versions; no kernel path calls it.
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    # (B, L, H, D) -> (B*H, L, D) for the plain versions (CPU only)
    return x.transpose(1, 2).flatten(0, 1)


def _heads_last(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    # (B*H, L, D) -> contiguous (B, L, H, D), the kernels' output layout
    return x.unflatten(0, (b, h)).transpose(1, 2).contiguous()


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


def _check_4d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              **more: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: every tensor on q's CUDA
    device, bf16, (B, seq, H, 64) in a layout TMA reads; k and v of one
    shape, and of q's batch and heads; ``more`` (o, dO) of q's shape."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
        if x.device != q.device or x.dtype != torch.bfloat16:
            raise ValueError(f"the flash kernel takes bf16 on {q.device}; "
                             f"{name} is {x.dtype} on {x.device}")
        if x.dim() != 4 or x.shape[-1] != 64:
            raise ValueError(f"the flash kernel takes (B, seq, H, 64); "
                             f"{name} is {tuple(x.shape)}")
        check_tma_layout(x, name)
    b, s_len, h, _ = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != h
            or s_len == 0 or k.shape[1] == 0
            or any(x.shape != q.shape for x in more.values())):
        raise ValueError("shape mismatch: " + ", ".join(
            f"{n} {tuple(x.shape)}"
            for n, x in (("q", q), ("k", k), ("v", v), *more.items())))


def _strides(*xs: torch.Tensor):
    """The (batch, seq, head) element strides of each tensor, as the C
    entries take them."""
    return (ctypes.c_longlong * (3 * len(xs)))(
        *(st for x in xs for st in x.stride()[:3]))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


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
    _check_4d(q, k, v)
    b, s_len, h, _ = q.shape
    t_len = k.shape[1]
    if pipelined and not _pipelined_takes(t_len):
        raise ValueError(f"the pipelined forward takes T a multiple of "
                         f"{PIPELINED_BLOCK_KV} with at least two tiles; "
                         f"got {t_len}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b * h, s_len), dtype=torch.float32, device=q.device)
    name = "flash_fwd_pipelined_bf16" if pipelined else "flash_fwd_bf16"
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, s_len, t_len, _strides(q, k, v, o),
            float(scale), _stream(q))
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
    ref = (flash_fwd_pipelined_reference if pipelined
           else flash_attention_reference)
    o3, lse = ref(*(_heads_first(x) for x in (q, k, v)), scale)
    return _heads_last(o3, q.shape[0], q.shape[2]), lse


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
    """rowsum(dO * O) in fp32, (BH, S): the plain versions' delta (on the
    card the dq kernel computes it)."""
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


def flash_bwd_tiled_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              scale: float, block_kv: int = PIPELINED_BLOCK_KV
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of both backward kernels' arithmetic, kv tile by kv
    tile: delta = rowsum(dO * O) in fp32 from the saved o and dO, fp32 score
    tiles, ``p = exp2(s * scale * log2 e - lse * log2 e)``,
    ``ds = p * (dO v^T - delta)``, ``p`` (for dv) and ``ds`` (for dq and dk)
    rounded to the inputs' dtype before their products, the scale applied to
    dq and dk at the end.  Any T: the last tile may be short.  The kernels
    round p and ds as this does, so this, not the one-pass
    :func:`flash_bwd_reference`, is what they match to a few bf16 ulps.

    q, o, do (BH, S, D), k/v (BH, T, D), lse (BH, S) -> (dq, dk, dv) in the
    inputs' dtypes."""
    c = scale * _LOG2E
    delta = _delta(o, do)[..., None]
    lse2 = lse[..., None] * _LOG2E
    qf, dof = q.float(), do.float()
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(0, k.shape[1], block_kv):
        kj, vj = k[:, j:j + block_kv].float(), v[:, j:j + block_kv].float()
        p = torch.exp2(torch.einsum("bsd,btd->bst", qf, kj) * c - lse2)
        ds = p * (torch.einsum("bsd,btd->bst", dof, vj) - delta)
        dvs.append(torch.einsum("bst,bsd->btd", p.to(do.dtype).float(), dof))
        dks.append(torch.einsum("bst,bsd->btd", ds.to(q.dtype).float(), qf))
        dq += torch.einsum("bst,btd->bsd", ds.to(k.dtype).float(), kj)
    return ((dq * scale).to(q.dtype), (torch.cat(dks, 1) * scale).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


def _check_stats(q: torch.Tensor, **stats: torch.Tensor) -> None:
    """lse and delta: contiguous fp32 (B*H, S) on q's device."""
    b, s_len, h, _ = q.shape
    for name, x in stats.items():
        if (x.shape != (b * h, s_len) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 ({b * h}, "
                             f"{s_len}) on {q.device}; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dq (B, S, H, 64) contiguous and delta = rowsum(dO * O) (B*H, S) fp32,
    from (B, L, H, 64) q, k, v, the forward's o and lse, and the incoming
    dO, in any layout TMA reads.  No copy is made.

    CUDA: the dq kernel on the current stream (it computes delta too);
    raises on anything it does not take.  CPU: the plain versions."""
    if q.device.type == "cpu":
        q3, k3, v3, o3, do3 = (_heads_first(x) for x in (q, k, v, o, do))
        delta = _delta(o3, do3)
        dq = flash_bwd_dq_reference(q3, k3, v3, do3, lse, delta, scale)
        return _heads_last(dq, q.shape[0], q.shape[2]), delta
    _check_4d(q, k, v, o=o, do=do)
    _check_stats(q, lse=lse)
    b, s_len, h, _ = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((b * h, s_len), dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dq_bf16", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, h, s_len, k.shape[1],
            _strides(q, k, v, o, do, dq), float(scale), _stream(q))
    flash_attention.bwd_dq_launches += 1
    return dq, delta


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv (B, T, H, 64) contiguous from (B, L, H, 64) q, k, v, dO in any
    layout TMA reads, the forward's lse and :func:`flash_bwd_dq`'s delta.

    CUDA: the dk/dv kernel on the current stream; raises on anything it
    does not take.  CPU: the plain version."""
    if q.device.type == "cpu":
        dk, dv = flash_bwd_dkv_reference(
            *(_heads_first(x) for x in (q, k, v, do)), lse, delta, scale)
        return (_heads_last(dk, k.shape[0], k.shape[2]),
                _heads_last(dv, v.shape[0], v.shape[2]))
    _check_4d(q, k, v, do=do)
    _check_stats(q, lse=lse, delta=delta)
    b, s_len, h, _ = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("flash_bwd_dkv_bf16", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, s_len, k.shape[1],
            _strides(q, k, v, do, dk, dv), float(scale), _stream(q))
    flash_attention.bwd_dkv_launches += 1
    return dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_fwd`'s o w.r.t. q, k, v: (B, L, H, 64)
    inputs in any layout TMA reads, the forward's o and lse, the incoming
    dO -> dq, dk, dv contiguous (B, L, H, 64).  No copy is made.

    CUDA: the dq kernel (with delta), then the dk/dv kernel, on the current
    stream; raises on anything they do not take.  CPU: the plain
    versions."""
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, scale)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, scale))


def flash_bwd_dq_3d(q, k, v, o, lse, do, scale
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, S, 64) q, o, dO and (BH, T, 64) k, v -> (dq (BH, S, 64),
    delta (BH, S)): :func:`flash_bwd_dq` with H = 1."""
    dq, delta = flash_bwd_dq(*_as4d(q, k, v, o), lse, *_as4d(do), scale)
    return dq[:, :, 0], delta


def flash_bwd_dkv_3d(q, k, v, do, lse, delta, scale
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv (BH, T, 64): :func:`flash_bwd_dkv` with H = 1."""
    dk, dv = flash_bwd_dkv(*_as4d(q, k, v, do), lse, delta, scale)
    return dk[:, :, 0], dv[:, :, 0]


def flash_bwd_3d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_fwd_3d`'s o: :func:`flash_bwd` with
    H = 1."""
    grads = flash_bwd(*_as4d(q, k, v, o), lse, *_as4d(do), scale)
    return tuple(x[:, :, 0] for x in grads)


class FlashAttentionFn(torch.autograd.Function):
    """(B, S, H, 64) attention whose forward and backward are the kernels.

    Both read the (B, L, H, 64) views they are given through their strides
    and return contiguous tensors of that layout: the forward saves q, k, v
    as given with o and the LSE, and no copy is made in either direction
    (so the caller's reshape of o, and autograd's of the gradients, are
    views)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_bwd(q, k, v, o, lse, grad_out, ctx.scale), None)


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
