"""Fused GroupNorm + SiLU + 3x3 convolution: the hand-written CUDA kernel and
its plain version (NCHW x, OIHW w).

Counterpart of ``diffute_tpu/ops/conv_fused.py``: every ResnetBlock2D half is
``conv3x3(silu(groupnorm(x)))``, and the kernel (``csrc/conv_fused.cu`` for
``_kernel``) normalises while it stages the convolution's operand, so the
normalised tensor is never written to device memory.  The statistics come
from :func:`~diffute_tpu_torch.ops.groupnorm.group_norm_stats`, once per
call.  None of the TPU kernel's VMEM gates exists here: every bf16 NCHW
tensor with ``Cin % 16 == 0``, ``Cin % groups == 0`` and ``W % 8 == 0``
launches, the 960-, 1920- and 2560-channel inputs included.

The kernel reads the weight repacked in its own tile order
(:func:`pack_conv3x3_weight`, the counterpart of the JAX package's
``w.reshape(9*c, cout)``).  A module packs it once and passes it as
``packed``; without it this function packs in the call.

On a CUDA tensor the wrapper launches or raises; on a CPU tensor it computes
the plain version.  Usable under autograd: the backward differentiates the
plain version, as the JAX package's custom VJP does (no backward kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from diffute_tpu_torch.ops.flash_attention import _launch
from diffute_tpu_torch.ops.groupnorm import (
    _check_x,
    check_affine,
    group_norm_silu_reference,
    group_norm_stats,
)

# blocks the kernel aims to put on the card before it splits Cin (two per SM)
_TARGET_BLOCKS = 264
_MAX_SPLITS = 8
# the kernel's tile: output channels per block, input channels per chunk
COUT_TILE, CIN_CHUNK = 128, 16


def gn_silu_conv3x3_reference(x: torch.Tensor, gn_weight: torch.Tensor,
                              gn_bias: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, groups: int = 32,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain version (``_xla_ref``): the normalised tensor rounded to x's
    dtype, then the zero-padded 3x3 convolution and the bias in fp32, rounded
    to x's dtype."""
    h = group_norm_silu_reference(x, gn_weight, gn_bias, groups, eps)
    y = F.conv2d(h.float(), w.float(), b.float(), padding=1)
    return y.to(x.dtype)


def pack_conv3x3_weight(w: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> contiguous (ceil(Cout/128), Cin/16, 128, 9,
    16) in ``dtype``: ``[t, c, o, 3*ky + kx, i] = w[128*t + o, 16*c + i, ky,
    kx]``, zero past Cout.  The kernel's A operand: what one block (128
    output channels) reads for one chunk of 16 input channels is one
    contiguous run."""
    if w.dim() != 4 or w.shape[2:] != (3, 3) or w.shape[1] % CIN_CHUNK:
        raise ValueError(f"w must be (Cout, Cin, 3, 3) with Cin % {CIN_CHUNK} "
                         f"== 0; got {tuple(w.shape)}")
    cout, cin = w.shape[:2]
    tiles = -(-cout // COUT_TILE)
    w = F.pad(w.detach().to(dtype), (0, 0, 0, 0, 0, 0, 0,
                                     tiles * COUT_TILE - cout))
    w = w.reshape(tiles, COUT_TILE, cin // CIN_CHUNK, CIN_CHUNK, 9)
    return w.permute(0, 2, 1, 4, 3).contiguous()


def _forward(x, gn_weight, gn_bias, w, b, packed, groups, eps):
    if x.device.type == "cpu":
        return gn_silu_conv3x3_reference(x, gn_weight, gn_bias, w, b, groups,
                                         eps)
    _check_x(x, groups, "GN+SiLU+conv3x3")
    bsz, cin, h_, w_ = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin, 3, 3):
        raise ValueError(f"w must be ({cout}, {cin}, 3, 3); got "
                         f"{tuple(w.shape)}")
    if cin % 16 or w_ % 8:
        raise ValueError(f"the GN+SiLU+conv3x3 kernel takes Cin % 16 == 0 "
                         f"and W % 8 == 0; got Cin {cin}, W {w_}")
    if packed is None:
        packed = pack_conv3x3_weight(w)
    packed_shape = (-(-cout // COUT_TILE), cin // CIN_CHUNK, COUT_TILE, 9,
                    CIN_CHUNK)
    if (packed.shape != packed_shape or packed.dtype != torch.bfloat16
            or packed.device != x.device or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(f"packed must be contiguous bf16 {packed_shape} on "
                         f"{x.device}; got {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device}")
    gn_bf16 = check_affine(x, cin, gn_weight=gn_weight, gn_bias=gn_bias)
    bias_bf16 = check_affine(x, cout, b=b)
    mean, rstd = group_norm_stats(x, groups, eps)
    # 128 channels x 64 pixels per block; split Cin's 16-channel chunks where
    # that grid would leave the card empty (the 8^2 and 16^2 levels)
    tile_rows = 4 if w_ % 16 == 0 else 8
    blocks = (bsz * -(-h_ // tile_rows) * (w_ * tile_rows // 64)
              * -(-cout // COUT_TILE))
    n_chunks = cin // CIN_CHUNK
    splits = max(1, min(_TARGET_BLOCKS // blocks, _MAX_SPLITS, n_chunks))
    splits = -(-n_chunks // -(-n_chunks // splits))  # no empty split
    # out and partial are made per call, on the stream that launches the
    # kernel: the caching allocator hands a block back only to the stream it
    # was allocated on, so edits in flight on two streams never share them
    out = torch.empty((bsz, cout, h_, w_), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, bsz, cout, h_, w_), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    _launch("gn_silu_conv3x3_bf16", x.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), gn_weight.data_ptr(), gn_bias.data_ptr(),
            int(gn_bf16), packed.data_ptr(), b.data_ptr(), int(bias_bf16),
            out.data_ptr(), partial.data_ptr() if splits > 1 else None,
            bsz, cin, cout, h_, w_, groups, splits,
            torch.cuda.current_stream(x.device).cuda_stream)
    gn_silu_conv3x3.launches += 1
    gn_silu_conv3x3.flops += 2 * bsz * h_ * w_ * cout * 9 * cin
    return out


class _GnSiluConvFn(torch.autograd.Function):
    """Forward by the kernel; backward through the plain version."""

    @staticmethod
    def forward(ctx, x, gn_weight, gn_bias, w, b, packed, groups, eps):
        ctx.save_for_backward(x, gn_weight, gn_bias, w, b)
        ctx.groups, ctx.eps = groups, eps
        return _forward(x, gn_weight, gn_bias, w, b, packed, groups, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = gn_silu_conv3x3_reference(*leaves, ctx.groups, ctx.eps)
        return (*torch.autograd.grad(y, leaves, grad_out), None, None, None)


def gn_silu_conv3x3(x: torch.Tensor, gn_weight: torch.Tensor,
                    gn_bias: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5,
                    packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv3x3(silu(groupnorm(x)), padding 1) + b`` with the normalised
    tensor kept out of device memory.

    x (B, Cin, H, W); gn_weight / gn_bias (Cin,); w (Cout, Cin, 3, 3); b
    (Cout,); ``packed`` is ``pack_conv3x3_weight(w)``, made once by the
    caller.  Differentiable in the first five.  Kernel launches are counted
    in ``gn_silu_conv3x3.launches`` (CUDA only)."""
    args = (x, gn_weight, gn_bias, w, b)
    if x.device.type == "cpu":  # autograd differentiates the plain version
        return gn_silu_conv3x3_reference(*args, groups, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GnSiluConvFn.apply(*args, packed, groups, eps)
    return _forward(*args, packed, groups, eps)


gn_silu_conv3x3.launches = 0
# matrix-product FLOPs of the launches (edit_profiled reads it)
gn_silu_conv3x3.flops = 0
