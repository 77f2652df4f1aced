"""Fused GroupNorm + SiLU: the hand-written CUDA kernels and their plain
version (NCHW).

Counterpart of ``diffute_tpu/ops/groupnorm.py``.  ``_gn_silu_kernel`` (one
sample's NHWC slab in VMEM, statistics by one-hot matmuls) becomes two
launches of ``csrc/groupnorm.cu``: :func:`group_norm_stats` (fp32 mean and
rstd per sample and group, shared with ``ops/conv_fused.py``) and the apply
``silu(x * a_c + d_c)``.  None of the TPU kernel's VMEM gates exists here:
every bf16 NCHW tensor with ``C % groups == 0`` and ``H*W % 8 == 0`` launches.

On a CUDA tensor every wrapper launches its kernel or raises; none falls
back.  On a CPU tensor it computes the plain version (fp32 inside, the mean
subtracted before squaring), which is what the CPU tests compare against the
JAX package.  The function is usable under autograd: the backward
differentiates the plain version, as the JAX package's custom VJP does (it
has no backward kernel).
"""

from __future__ import annotations

from typing import Tuple

import torch

from diffute_tpu_torch.ops.flash_attention import _launch

# blocks the statistics pass aims to put on the card (two per SM)
_TARGET_BLOCKS = 264
_tickets = {}  # (device, stream) -> zeroed int32 ticket counters


def stream_tickets(cache: dict, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 ticket counters owned by ``device``'s
    current stream.  A kernel that merges its blocks' partial results "in
    the last block to finish" counts arrivals in them and leaves them zero,
    so launches queued on ONE stream can share a buffer; two streams run
    concurrently and must never share a counter, hence the key.  Allocated
    once per stream (inside the caller's stream context, so the caching
    allocator ties the memory to that stream), not per launch."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    tickets = cache.get(key)
    if tickets is None or tickets.numel() < n:
        tickets = cache[key] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                           device=device)
    return tickets


def group_norm_stats_reference(x: torch.Tensor, groups: int, eps: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 (mean, rstd), each (B, groups), of an NCHW tensor."""
    b = x.shape[0]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2)
    var = (xf - mean[..., None]).square().mean(dim=2)
    return mean, torch.rsqrt(var + eps)


def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, groups: int = 32,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain version: ``silu(GroupNorm(x) * weight + bias)`` in fp32, cast to
    ``x.dtype`` (``_xla_gn_silu``).  x (B, C, H, W), weight / bias (C,)."""
    b, c = x.shape[:2]
    mean, rstd = group_norm_stats_reference(x, groups, eps)
    xf = x.float().reshape(b, groups, -1)
    y = ((xf - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    y = y * weight.float().view(1, c, 1, 1) + bias.float().view(1, c, 1, 1)
    return (y * torch.sigmoid(y)).to(x.dtype)


def _check_x(x: torch.Tensor, groups: int, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the {what} kernel takes bf16; x is {x.dtype}")
    if x.dim() != 4 or x.shape[1] % groups or 0 in x.shape:
        raise ValueError(f"{what} takes (B, C, H, W) with C % {groups} == 0; "
                         f"x is {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous (NCHW) and 16-byte aligned")


def check_affine(ref: torch.Tensor, n: int, **params: torch.Tensor) -> bool:
    """Raise unless every tensor is a contiguous (n,) vector on ``ref``'s
    device, all bf16 or all fp32; return whether they are bf16."""
    dtypes = {p.dtype for p in params.values()}
    if len(dtypes) != 1 or not dtypes <= {torch.bfloat16, torch.float32}:
        raise ValueError(f"{list(params)} must share bf16 or fp32; "
                         f"got {sorted(map(str, dtypes))}")
    for name, p in params.items():
        if p.shape != (n,) or p.device != ref.device or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n},) vector on "
                             f"{ref.device}; got {tuple(p.shape)} on {p.device}")
    return dtypes == {torch.bfloat16}


def group_norm_stats(x: torch.Tensor, groups: int = 32, eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (mean, rstd), each (B, groups), of x (B, C, H, W).

    CUDA: checks and launches the statistics kernel on the current stream
    (bf16, ``(C/groups)*H*W % 8 == 0``).  CPU: the plain version."""
    if x.device.type == "cpu":
        return group_norm_stats_reference(x, groups, eps)
    _check_x(x, groups, "GroupNorm statistics")
    b, c, h, w = x.shape
    n_elem = (c // groups) * h * w
    if n_elem % 8:
        raise ValueError(f"a group's (C/groups)*H*W = {n_elem} elements must "
                         "be a multiple of 8")
    n_groups, n_vec = b * groups, n_elem // 8
    # split a group's run where one block per group would leave the card
    # empty; every piece keeps at least one vector per thread
    splits = max(1, min(-(-_TARGET_BLOCKS // n_groups), n_vec // 256))
    per = -(-n_vec // splits)
    splits = -(-n_vec // per)
    mean, rstd = torch.empty((2, b, groups), dtype=torch.float32,
                             device=x.device)
    partial = tickets = None
    if splits > 1:
        partial = torch.empty((n_groups, splits, 2), dtype=torch.float32,
                              device=x.device)
        tickets = stream_tickets(_tickets, x.device, n_groups)
    _launch("gn_stats_bf16", x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            partial.data_ptr() if splits > 1 else None,
            tickets.data_ptr() if splits > 1 else None,
            n_groups, n_elem, splits, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    group_norm_stats.launches += 1
    return mean, rstd


group_norm_stats.launches = 0


def _forward(x, weight, bias, groups, eps):
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, weight, bias, groups, eps)
    _check_x(x, groups, "GroupNorm+SiLU")
    b, c, h, w = x.shape
    if (h * w) % 8:
        raise ValueError(f"H*W = {h * w} must be a multiple of 8")
    affine_bf16 = check_affine(x, c, weight=weight, bias=bias)
    mean, rstd = group_norm_stats(x, groups, eps)
    y = torch.empty_like(x)
    _launch("gn_silu_apply_bf16", x.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), int(affine_bf16), mean.data_ptr(),
            rstd.data_ptr(), y.data_ptr(), b, c, h * w, groups,
            torch.cuda.current_stream(x.device).cuda_stream)
    group_norm_silu.launches += 1
    return y


class _GroupNormSiLUFn(torch.autograd.Function):
    """Forward by the kernel; backward through the plain version."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.groups, ctx.eps = groups, eps
        return _forward(x, weight, bias, groups, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = group_norm_silu_reference(*leaves, ctx.groups, ctx.eps)
        return (*torch.autograd.grad(y, leaves, grad_out), None, None)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """``silu(GroupNorm(x) * weight + bias)`` over x (B, C, H, W) with
    per-channel ``weight`` / ``bias`` (C,), fp32 statistics, output in x's
    dtype; differentiable in all three.

    Kernel launches are counted (CUDA only): ``group_norm_silu.launches`` the
    apply kernel, ``group_norm_stats.launches`` the statistics kernel (which
    the fused conv launches too)."""
    if x.device.type == "cpu":  # autograd differentiates the plain version
        return group_norm_silu_reference(x, weight, bias, groups, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSiLUFn.apply(x, weight, bias, groups, eps)
    return _forward(x, weight, bias, groups, eps)


group_norm_silu.launches = 0
