"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Counterpart of ``diffute_tpu/ops/flash_attention.py``'s forward
(``_flash_fwd_3d`` + ``_fwd_kernel``).  The kernel, ``csrc/flash_fwd.cu``,
takes bf16 q/k/v of head_dim 64 as (batch*heads, seq, 64) and returns the
output and the natural-log LSE; the public function keeps the JAX package's
(batch, seq, heads, head_dim) layout.

On a CUDA tensor :func:`flash_attention` launches the kernel or raises; it
never falls back.  On a CPU tensor it computes the plain version, which is
what the CPU tests compare against the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _to3d(x: torch.Tensor) -> torch.Tensor:
    # (B, S, H, D) -> contiguous (B*H, S, D).  This transpose is a copy
    # (reshape alone may return a strided view, e.g. at B = 1); passing
    # strides to the kernel instead would remove it.
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


def flash_fwd_3d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (BH, S, 64), k/v (BH, T, 64) -> (o (BH, S, 64), lse (BH, S)).

    CUDA: checks and launches the kernel on the current stream (raises on
    anything it does not take).  CPU: the plain version."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"the flash kernel takes bf16; {name} is {x.dtype}")
        if x.dim() != 3 or x.shape[-1] != 64:
            raise ValueError(f"the flash kernel takes (BH, seq, 64); "
                             f"{name} is {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    bh, s_len, _ = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[1] == 0 or s_len == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    from diffute_tpu_torch.ops import _build

    lib = _build.load()
    o = torch.empty_like(q)
    lse = torch.empty((bh, s_len), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), lse.data_ptr(), bh, s_len,
                             k.shape[1], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_bf16 launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over (batch, seq, heads, head_dim) tensors.

    ``flash_attention.launches`` counts kernel launches (CUDA only)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, _, h, _ = q.shape
    o3, _ = flash_fwd_3d(_to3d(q), _to3d(k), _to3d(v), scale)
    return _from3d(o3, b, h)


flash_attention.launches = 0
