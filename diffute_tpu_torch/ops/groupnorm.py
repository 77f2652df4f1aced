"""Fused GroupNorm + SiLU: the hand-written CUDA kernels and their plain
version (NCHW).

Counterpart of ``diffute_tpu/ops/groupnorm.py``.  ``_gn_silu_kernel`` (one
sample's NHWC slab in VMEM, statistics by one-hot matmuls) becomes
``csrc/groupnorm.cu``: :func:`group_norm_silu` is one launch (statistics,
affine and SiLU; x read once), and :func:`group_norm_stats` the statistics
alone (fp32 mean and rstd per sample and group), which ``ops/conv_fused.py``
launches before its conv.  Both run a (sample, group) as one thread block
cluster whose blocks merge their pieces through distributed shared memory.
:func:`gn_plan` is their grid in plain Python, and
:func:`group_norm_stats_tiled_reference` their merge in plain torch.  None of
the TPU kernel's VMEM gates exists here: every bf16 NCHW tensor with
``C % groups == 0`` and ``H*W % 8 == 0`` launches, and every fp32 one with
``H*W % 4 == 0`` (the same kernels at 4 fp32 values a 16-byte vector, the
``_fp32`` entries).

On a CUDA tensor every wrapper launches its kernel or raises; none falls
back.  On a CPU tensor it computes the plain version (fp32 inside, the mean
subtracted before squaring), which is what the CPU tests compare against the
JAX package.  The function is usable under autograd: the backward
differentiates the plain version, as the JAX package's custom VJP does (it
has no backward kernel).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from diffute_tpu_torch.ops.flash_attention import _launch

# the card's SMs and its shared memory per SM.  A (sample, group) of up to
# SINGLE_BLOCK 16-byte vectors (8 bf16 or 4 fp32 values) is one block
# (measured on the H100: a cluster launch and its barriers cost more than the
# split saves there); a larger one
# is split over up to MAX_CLUSTER blocks (the portable cluster size) until the
# blocks cover the SMs and a piece fits MAX_SMEM.  A piece then holds at least
# SINGLE_BLOCK / MAX_CLUSTER vectors, so none is empty.
_SMS, _SMEM_PER_SM = 132, 233472
SINGLE_BLOCK, MAX_CLUSTER = 2048, 8
# vectors a thread aims to load (the kernels keep up to 8 in flight), the
# threads of a block (wider blocks pack worse into the clusters' SMs; a
# GN+SiLU block alone on its SM takes up to 1024), and the dynamic shared
# memory a GN+SiLU block may take (kMaxSmem in csrc/groupnorm.cu)
VECS_PER_THREAD, MAX_THREADS, MAX_SMEM = 4, 256, 232448 - 1024


def _width(vectors: int, per_thread: int, cap: int) -> int:
    return min(cap, max(64, (-(-vectors // per_thread) + 31) // 32 * 32))


@functools.lru_cache(maxsize=None)
def gn_plan(b: int, c: int, h: int, w: int, groups: int,
            itemsize: int = 2) -> dict:
    """The kernels' grid for x (b, c, h, w) of ``itemsize``-byte elements
    (2: bf16, 4: fp32): ``cluster`` blocks a (sample, group), block r owning
    vectors [r*per, (r+1)*per) of the group's ``n_vec`` 16-byte vectors of
    ``per_vec`` elements (the last block the rest, never none), with
    ``threads`` threads for the statistics.  For GN+SiLU, ``staged`` of a
    block's vectors go through ``smem`` bytes of shared memory: the whole
    piece (``one_read``) unless it exceeds MAX_SMEM, when the rest is read
    twice; ``silu_threads`` threads, more where ``smem`` leaves the block
    alone on its SM."""
    if itemsize not in (2, 4):
        raise ValueError(f"the kernels take 2- or 4-byte elements; got "
                         f"{itemsize}")
    per_vec = 16 // itemsize
    if c % groups or (c // groups) * h * w % per_vec:
        raise ValueError(f"(C/groups)*H*W of {(b, c, h, w)} over {groups} "
                         f"groups must be a whole multiple of {per_vec}")
    cpg, n_groups = c // groups, b * groups
    n_vec = cpg * h * w // per_vec
    stage_cap = (MAX_SMEM - 8 * cpg) // 16
    cluster = 1
    while n_vec > SINGLE_BLOCK and cluster < MAX_CLUSTER and (
            n_groups * cluster < _SMS or -(-n_vec // cluster) > stage_cap):
        cluster *= 2
    per = -(-n_vec // cluster)
    threads = _width(per, VECS_PER_THREAD, MAX_THREADS)
    staged = min(per, stage_cap)
    smem = 16 * staged + 8 * cpg
    alone = _SMEM_PER_SM // (smem + 2048) < 2
    silu_threads = (max(threads, _width(per, 8, 1024)) if alone else threads)
    return dict(n_vec=n_vec, per_vec=per_vec, cluster=cluster, per=per,
                threads=threads, silu_threads=silu_threads,
                blocks=n_groups * cluster, staged=staged, smem=smem,
                one_read=staged == per)


def group_norm_stats_reference(x: torch.Tensor, groups: int, eps: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 (mean, rstd), each (B, groups), of an NCHW tensor."""
    b = x.shape[0]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2)
    var = (xf - mean[..., None]).square().mean(dim=2)
    return mean, torch.rsqrt(var + eps)


def group_norm_stats_tiled_reference(
        x: torch.Tensor, groups: int, eps: float,
        ranks: Optional[Sequence[int]] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' merge in plain fp32 torch: each of :func:`gn_plan`'s
    pieces of a group reduced to (count, mean, M2), its mean subtracted
    before squaring, then the pieces folded in rank order with Chan's
    formula.  ``ranks`` folds only those pieces (all by default).  The
    plan is x's: bf16 and fp32 tensors split into other pieces."""
    b, c, h, w = x.shape
    plan = gn_plan(b, c, h, w, groups, x.element_size())
    xf = x.float().reshape(b * groups, -1)
    n = mean = m2 = torch.zeros(b * groups, dtype=torch.float32,
                                device=x.device)
    run = plan["per_vec"] * plan["per"]  # elements of a piece
    for r in (range(plan["cluster"]) if ranks is None else ranks):
        piece = xf[:, r * run:(r + 1) * run]
        n_b = float(piece.shape[1])
        mean_b = piece.mean(dim=1)
        m2_b = (piece - mean_b[:, None]).square().sum(dim=1)
        n_ab = n + n_b
        d = mean_b - mean
        mean = mean + d * (n_b / n_ab)
        m2 = m2 + m2_b + d * d * (n * n_b / n_ab)
        n = n_ab
    return (mean.reshape(b, groups),
            torch.rsqrt(m2 / n + eps).reshape(b, groups))


def group_norm_silu_from_stats(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, mean: torch.Tensor,
                               rstd: torch.Tensor) -> torch.Tensor:
    """``silu((x - mean) * rstd * weight + bias)`` in fp32 from given (B,
    groups) statistics, cast to ``x.dtype``."""
    b, c = x.shape[:2]
    groups = mean.shape[1]
    xf = x.float().reshape(b, groups, -1)
    y = ((xf - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    y = y * weight.float().view(1, c, 1, 1) + bias.float().view(1, c, 1, 1)
    return (y * torch.sigmoid(y)).to(x.dtype)


def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, groups: int = 32,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain version: ``silu(GroupNorm(x) * weight + bias)`` in fp32, cast to
    ``x.dtype`` (``_xla_gn_silu``).  x (B, C, H, W), weight / bias (C,)."""
    mean, rstd = group_norm_stats_reference(x, groups, eps)
    return group_norm_silu_from_stats(x, weight, bias, mean, rstd)


# the kernels' entry suffix by x's dtype
_ENTRY = {torch.bfloat16: "bf16", torch.float32: "fp32"}


def _check_x(x: torch.Tensor, groups: int, what: str,
             dtypes: Sequence[torch.dtype] = tuple(_ENTRY)) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"the {what} kernel takes "
                         f"{' or '.join(_ENTRY[d] for d in dtypes)}; x is "
                         f"{x.dtype}")
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
    (bf16 with ``(C/groups)*H*W % 8 == 0``, or fp32 with ``% 4``).  CPU: the
    plain version."""
    if x.device.type == "cpu":
        return group_norm_stats_reference(x, groups, eps)
    _check_x(x, groups, "GroupNorm statistics")
    b, c, h, w = x.shape
    plan = gn_plan(b, c, h, w, groups, x.element_size())
    mean, rstd = torch.empty((2, b, groups), dtype=torch.float32,
                             device=x.device)
    _launch(f"gn_stats_{_ENTRY[x.dtype]}", x.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), b * groups, plan["per_vec"] * plan["n_vec"],
            plan["cluster"], plan["threads"], float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    group_norm_stats.launches += 1
    return mean, rstd


group_norm_stats.launches = 0


def _forward(x, weight, bias, groups, eps):
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, weight, bias, groups, eps)
    _check_x(x, groups, "GroupNorm+SiLU")
    b, c, h, w = x.shape
    plan = gn_plan(b, c, h, w, groups, x.element_size())
    if (h * w) % plan["per_vec"]:
        raise ValueError(f"H*W = {h * w} must be a multiple of "
                         f"{plan['per_vec']}")
    affine_bf16 = check_affine(x, c, weight=weight, bias=bias)
    y = torch.empty_like(x)
    _launch(f"gn_silu_{_ENTRY[x.dtype]}", x.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), int(affine_bf16), y.data_ptr(), b, c, h * w,
            groups, plan["cluster"], plan["silu_threads"], plan["staged"],
            float(eps), torch.cuda.current_stream(x.device).cuda_stream)
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
    one GN+SiLU kernel, ``group_norm_stats.launches`` the statistics kernel
    (which the fused conv launches)."""
    if x.device.type == "cpu":  # autograd differentiates the plain version
        return group_norm_silu_reference(x, weight, bias, groups, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSiLUFn.apply(x, weight, bias, groups, eps)
    return _forward(x, weight, bias, groups, eps)


group_norm_silu.launches = 0
