"""Fused GroupNorm + SiLU + 3x3 convolution: the hand-written CUDA kernels
and their plain version (NCHW x, OIHW w).

Counterpart of ``diffute_tpu/ops/conv_fused.py``: every ResnetBlock2D half is
``conv3x3(silu(groupnorm(x)))``, and the kernels (``csrc/conv_fused.cu`` on
bf16 x, ``csrc/conv_fused_fp32.cu`` on fp32 x, both for ``_kernel``)
normalise while they stage the convolution's operand, so the normalised
tensor is never written to device memory.  The statistics come from
:func:`~diffute_tpu_torch.ops.groupnorm.group_norm_stats`, once per call; the
bf16 conv kernel is launched as that kernel's programmatic dependent, so its
prologue and first weight copies overlap the statistics.  None of the TPU
kernel's VMEM gates exists here: every bf16 NCHW tensor with ``Cin % 16 ==
0``, ``Cin % groups == 0`` and ``W % 8 == 0`` launches, and every fp32 one
with ``Cin % 8 == 0`` in place of the first, the 960-, 1920- and
2560-channel inputs included.

The bf16 kernel reads the weight repacked in its own tile order
(:func:`pack_conv3x3_weight`, the counterpart of the JAX package's
``w.reshape(9*c, cout)``): each kernel row's weights of a chunk for the Cout
tiles one block owns are one contiguous run, laid out as the kernel's
shared-memory operand.  A module packs it once and passes it as ``packed``;
without it this function packs in the call.  The fp32 kernel reads the fp32
OIHW weight as the layer keeps it (a chunk of 8 input channels is 72
contiguous floats of an output channel) and takes no ``packed``.
:func:`conv_plan` and :func:`conv_fp32_plan` are the kernels' grids, in
plain Python; :func:`gn_silu_conv3x3_tf32_reference` is the fp32 kernel's
3xTF32 products in plain torch.

On a CUDA tensor the wrapper launches or raises; on a CPU tensor it computes
the plain version.  Usable under autograd: the backward differentiates the
plain version, as the JAX package's custom VJP does (no backward kernel).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from diffute_tpu_torch.ops.flash_attention import _launch, round_tf32
from diffute_tpu_torch.ops.groupnorm import (
    _check_x,
    check_affine,
    group_norm_silu_reference,
    group_norm_stats,
)

# the card's SMs: one block of the kernel fills one (it takes up to 225 KB
# of shared memory); Cin is split where the grid would leave them empty
_SMS = 132
_MAX_SPLITS = 32
# the kernel's tile: output channels of one wgmma tile, input channels per
# chunk, output pixels per block, Cout tiles a block owns at most
COUT_TILE, CIN_CHUNK, PIXELS, MAX_TILES = 64, 16, 64, 5
# the fp32 kernel's (csrc/conv_fused_fp32.cu): 64 output channels x an 8 x 8
# pixel tile a block, Cin in chunks of 8; two blocks fit an SM, and Cin is
# split where the grid would fill fewer than FP32_TARGET_BLOCKS, no split
# under FP32_MIN_CHUNKS chunks
FP32_COUT_TILE, FP32_TILE, FP32_CIN_CHUNK = 64, 8, 8
FP32_TARGET_BLOCKS, FP32_MIN_CHUNKS = 2 * _SMS, 4
# the dtypes of x the kernels take
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


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


def gn_silu_conv3x3_tf32_reference(x: torch.Tensor, gn_weight: torch.Tensor,
                                   gn_bias: torch.Tensor, w: torch.Tensor,
                                   b: torch.Tensor, groups: int = 32,
                                   eps: float = 1e-5,
                                   products: int = 3) -> torch.Tensor:
    """The fp32 kernel's products in plain fp32 torch: the normalised tensor
    n and w each split into TF32 hi and lo (``round_tf32``, cvt.rna), and
    ``n w`` as ``n_lo w_hi + n_hi w_lo + n_hi w_hi``, then the bias.
    ``products=1`` keeps ``n_hi w_hi`` alone: what TF32 would compute (a
    mutant).  On a card, call it with TF32 off."""
    n = group_norm_silu_reference(x.float(), gn_weight, gn_bias, groups, eps)
    n_hi, w_hi = round_tf32(n), round_tf32(w)
    y = F.conv2d(n_hi, w_hi, padding=1)
    if products == 3:
        n_lo, w_lo = round_tf32(n - n_hi), round_tf32(w.float() - w_hi)
        y = (F.conv2d(n_lo, w_hi, padding=1) + F.conv2d(n_hi, w_lo, padding=1)
             + y)
    return y + b.float().view(1, -1, 1, 1)


def pack_conv3x3_weight(w: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> contiguous (Cin/16, 3, ceil(Cout/64), 3, 16,
    64) in ``dtype``: ``[c, ky, t, kx, i]`` is the row of output channels
    ``64*t .. 64*t + 63`` (zero past Cout) for input channel ``16*c + i``
    and tap ``(ky, kx)``, its 16-byte chunk ``j`` (channels ``8j .. 8j + 7``)
    stored at position ``j ^ (i % 8)``.  That is the kernel's A operand as
    it lies in shared memory (MN-major, 128-byte swizzle), so what one block
    reads for one kernel row of one chunk of 16 input channels is one
    contiguous run."""
    if w.dim() != 4 or w.shape[2:] != (3, 3) or w.shape[1] % CIN_CHUNK:
        raise ValueError(f"w must be (Cout, Cin, 3, 3) with Cin % {CIN_CHUNK} "
                         f"== 0; got {tuple(w.shape)}")
    cout, cin = w.shape[:2]
    tiles, chunks = -(-cout // COUT_TILE), cin // CIN_CHUNK
    w = F.pad(w.detach().to(dtype), (0, 0, 0, 0, 0, 0, 0,
                                     tiles * COUT_TILE - cout))
    # (t, o, c, i, ky, kx) -> (c, ky, t, kx, i, o)
    w = w.reshape(tiles, COUT_TILE, chunks, CIN_CHUNK, 3, 3)
    w = w.permute(2, 4, 0, 5, 3, 1).reshape(chunks, 3, tiles, 3, CIN_CHUNK,
                                            8, 8)
    rows = torch.arange(CIN_CHUNK, device=w.device)[:, None]
    swizzled = torch.arange(8, device=w.device)[None, :] ^ (rows % 8)
    return w[..., rows, swizzled, :].reshape(
        chunks, 3, tiles, 3, CIN_CHUNK, COUT_TILE).contiguous()


@functools.lru_cache(maxsize=None)
def conv_plan(batch: int, cin: int, cout: int, h: int, w: int) -> dict:
    """The kernel's grid for a (B, Cin, H, W) -> Cout call, in plain Python:
    the pixel tile (``tile_rows`` x ``tile_w`` = 64 pixels, the widest that
    divides W), the Cout tiles of 64 a block owns (at most five, balanced:
    all of Cout 320, a quarter of 1280), and the split of Cin's 16-channel
    chunks where the blocks would not fill the card (no split empty)."""
    tile_w = next(t for t in (64, 32, 16, 8) if w % t == 0)
    tile_rows = PIXELS // tile_w
    pixel_tiles = batch * -(-h // tile_rows) * (w // tile_w)
    m_tiles = -(-cout // COUT_TILE)
    co_blocks = -(-m_tiles // MAX_TILES)
    tiles = -(-m_tiles // co_blocks)
    co_blocks = -(-m_tiles // tiles)
    blocks = pixel_tiles * co_blocks
    n_chunks = cin // CIN_CHUNK
    splits = max(1, min(_SMS // blocks, n_chunks // 2, _MAX_SPLITS))
    splits = -(-n_chunks // -(-n_chunks // splits))  # no empty split
    return dict(tile_w=tile_w, tile_rows=tile_rows, pixel_tiles=pixel_tiles,
                m_tiles=m_tiles, tiles_per_block=tiles, co_blocks=co_blocks,
                chunks=n_chunks, splits=splits, blocks=blocks * splits)


@functools.lru_cache(maxsize=None)
def conv_fp32_plan(batch: int, cin: int, cout: int, h: int, w: int) -> dict:
    """The fp32 kernel's grid for a (B, Cin, H, W) -> Cout call, in plain
    Python: 8 x 8 pixel tiles (the last row of tiles may run past H), Cout
    tiles of 64, and the split of Cin's 8-channel chunks where the blocks
    would not fill FP32_TARGET_BLOCKS (at least FP32_MIN_CHUNKS chunks a
    split, no split empty)."""
    pixel_tiles = batch * -(-h // FP32_TILE) * (w // FP32_TILE)
    co_tiles = -(-cout // FP32_COUT_TILE)
    blocks = pixel_tiles * co_tiles
    n_chunks = cin // FP32_CIN_CHUNK
    splits = max(1, min(FP32_TARGET_BLOCKS // blocks,
                        n_chunks // FP32_MIN_CHUNKS, _MAX_SPLITS))
    per = -(-n_chunks // splits)
    splits = -(-n_chunks // per)  # no empty split
    return dict(pixel_tiles=pixel_tiles, co_tiles=co_tiles, chunks=n_chunks,
                splits=splits, chunks_per_split=per, blocks=blocks * splits)


def check_weight(x, w: torch.Tensor, packed: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Raise unless the kernel of x's dtype takes ``w`` and ``packed``;
    return the weight operand it reads: for bf16 x the repacked weight
    (``packed``, or packed here), for fp32 x ``w`` itself (fp32, OIHW, as
    the layer keeps it; no ``packed``)."""
    bsz, cin, h_, w_ = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"w must be ({cout}, {cin}, 3, 3); got "
                         f"{tuple(w.shape)}")
    chunk = CIN_CHUNK if x.dtype == torch.bfloat16 else FP32_CIN_CHUNK
    if cin % chunk or w_ % 8:
        raise ValueError(f"the GN+SiLU+conv3x3 kernel takes Cin % {chunk} == "
                         f"0 and W % 8 == 0 on {x.dtype}; got Cin {cin}, "
                         f"W {w_}")
    if x.dtype == torch.float32:
        if packed is not None:
            raise ValueError("the fp32 kernel reads w as the layer keeps it "
                             "(OIHW): pass no packed weight")
        if (w.dtype != torch.float32 or w.device != x.device
                or not w.is_contiguous() or w.data_ptr() % 16):
            raise ValueError(f"w must be contiguous fp32 on {x.device} for "
                             f"the fp32 kernel; got {w.dtype} on {w.device}")
        return w
    if packed is None:
        packed = pack_conv3x3_weight(w)
    packed_shape = (cin // CIN_CHUNK, 3, -(-cout // COUT_TILE), 3, CIN_CHUNK,
                    COUT_TILE)
    if (tuple(packed.shape) != packed_shape or packed.dtype != torch.bfloat16
            or packed.device != x.device or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(f"packed must be contiguous bf16 {packed_shape} on "
                         f"{x.device}; got {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device}")
    return packed


def _forward(x, gn_weight, gn_bias, w, b, packed, groups, eps):
    if x.device.type == "cpu":
        return gn_silu_conv3x3_reference(x, gn_weight, gn_bias, w, b, groups,
                                         eps)
    _check_x(x, groups, "GN+SiLU+conv3x3", KERNEL_DTYPES)
    weight = check_weight(x, w, packed)
    bsz, cin, h_, w_ = x.shape
    cout = w.shape[0]
    gn_bf16 = check_affine(x, cin, gn_weight=gn_weight, gn_bias=gn_bias)
    bias_bf16 = check_affine(x, cout, b=b)
    mean, rstd = group_norm_stats(x, groups, eps)
    fp32 = x.dtype == torch.float32
    plan = (conv_fp32_plan if fp32 else conv_plan)(bsz, cin, cout, h_, w_)
    splits = plan["splits"]
    # out and partial are made per call, on the stream that launches the
    # kernel: the caching allocator hands a block back only to the stream it
    # was allocated on, so edits in flight on two streams never share them
    out = torch.empty((bsz, cout, h_, w_), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, bsz, cout, h_, w_), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    _launch("gn_silu_conv3x3_" + ("fp32" if fp32 else "bf16"), x.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), gn_weight.data_ptr(),
            gn_bias.data_ptr(), int(gn_bf16), weight.data_ptr(),
            b.data_ptr(), int(bias_bf16),
            out.data_ptr(), partial.data_ptr() if splits > 1 else None,
            bsz, cin, cout, h_, w_, groups,
            *(() if fp32 else (plan["tiles_per_block"],)), splits,
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

    x (B, Cin, H, W), bf16 or fp32; gn_weight / gn_bias (Cin,); w (Cout,
    Cin, 3, 3); b (Cout,); for bf16 x ``packed`` is
    ``pack_conv3x3_weight(w)``, made once by the caller, for fp32 x none.
    Differentiable in the first five.  Kernel launches (either kernel) are
    counted in ``gn_silu_conv3x3.launches`` (CUDA only)."""
    args = (x, gn_weight, gn_bias, w, b)
    if x.device.type == "cpu":  # autograd differentiates the plain version
        return gn_silu_conv3x3_reference(*args, groups, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GnSiluConvFn.apply(*args, packed, groups, eps)
    return _forward(*args, packed, groups, eps)


gn_silu_conv3x3.launches = 0
# matrix-product FLOPs of the launches (edit_profiled reads it)
gn_silu_conv3x3.flops = 0
