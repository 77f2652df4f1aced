"""Int8 weight-only quantisation for serving: the hand-written CUDA matmul
and its plain version.

Counterpart of ``diffute_tpu/ops/quant.py``.  The UNet's transformer weights
are stored int8 with one scale per output feature and consumed by a matmul
that reads int8 from device memory and converts in registers
(``csrc/quant.cu`` for ``_w8_kernel``), halving the weight bytes a denoising
step streams.  Convolutions stay in the compute dtype.

Layout.  The port keeps a weight as ``nn.Linear`` does, ``(N, K)`` =
(out_features, in_features), one output feature per row; the JAX package
keeps ``(K, N)``.  So here ``q`` is ``(N, K)`` int8 and ``scale`` is ``(N,)``,
one per row: ``w[n, :] ~ q[n, :] * scale[n]``, ``scale[n] = max|w[n, :]| /
127``, symmetric round-to-nearest-even (``jnp.round``'s rule).  Transposed,
the numbers are the JAX package's bit for bit.

``quant_matmul`` computes ``y = (x @ q^T) * scale``, and with ``bias`` the
JAX layer's ``y + bias`` in x's dtype, without a dequantised matrix.  On a
CUDA tensor it launches a kernel or raises (bf16 or fp32 x, ``K % 16 == 0``;
the TPU kernel's ``N % 128`` gate is gone); on a CPU tensor it computes the
plain version.  The bf16 kernel reads ``q`` repacked once
(:func:`pack_w8_weight`; a layer caches it beside ``weight_q``, which stays
as it is); the fp32 kernel (``csrc/quant_fp32_sm90.cu``, two TF32 products
on ``wgmma``: x split as hi + lo, every int8 value exact in TF32) reads
``q`` as it is.
Inference only: no gradient is defined, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Iterable, Optional, Tuple

import torch

from diffute_tpu_torch.ops.flash_attention import _launch, round_tf32

# the card's SMs: one block of the kernel fills one.  K is split only where
# the output tiles leave them empty and K has at least _MIN_K_STEPS_TO_SPLIT
# steps of 64 (measured with tools/tune_w8_splits.py on an H100: a split
# lost at every K <= 2560 layer and won at K = 5120)
_SMS = 132
_MAX_SPLITS = 4
_MIN_K_STEPS_TO_SPLIT = 80
FEATURES_PER_BLOCK, K_STEP = 128, 64
_tickets = {}  # (device, stream) -> zeroed int32 ticket counters


def stream_tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 ticket counters owned by ``device``'s
    current stream.  The split-K kernel merges its blocks' partial results
    "in the last block to finish": it counts arrivals in them and leaves
    them zero, so launches queued on ONE stream can share a buffer; two
    streams run concurrently and must never share a counter, hence the key.
    Allocated once per stream (inside the caller's stream context, so the
    caching allocator ties the memory to that stream), not per launch."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    tickets = _tickets.get(key)
    if tickets is None or tickets.numel() < n:
        tickets = _tickets[key] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                              device=device)
    return tickets


def _quantize_rows(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = w.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K) float -> ((N, K) int8, (N,) fp32 scale), symmetric
    round-to-nearest per output feature (row).  An all-zero row gets scale 1."""
    return _quantize_rows(w.detach().float())


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(N, K) int8, (N,) -> (N, K) fp32."""
    return q.float() * scale.float()[:, None]


def quantize_blockwise(x: torch.Tensor, block: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape float -> ((nb, block) int8, (nb,) fp32 absmax scales): the
    flattened tensor, zero-padded to a block multiple, symmetric
    round-to-nearest per block."""
    flat = x.detach().float().reshape(-1)
    nb = -(-flat.numel() // block)
    flat = torch.nn.functional.pad(flat, (0, nb * block - flat.numel()))
    return _quantize_rows(flat.reshape(nb, block))


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` back to ``shape`` (fp32)."""
    flat = (q.float() * scale.float()[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def convert_linear_weights_to_int8(state_dict: Dict[str, torch.Tensor],
                                   prefixes: Iterable[str]
                                   ) -> Dict[str, torch.Tensor]:
    """Rewrite a float state_dict for a model whose layers named by
    ``prefixes`` are :class:`~diffute_tpu_torch.models.layers.QuantLinear`:
    ``<prefix>.weight`` becomes ``<prefix>.weight_q`` and
    ``<prefix>.weight_scale``; every other entry passes through (the
    counterpart of ``convert_dense_params_to_int8``).  Checkpoints stay
    float and are quantised once, at load."""
    out = dict(state_dict)
    for prefix in prefixes:
        q, scale = quantize_per_channel(out.pop(f"{prefix}.weight"))
        out[f"{prefix}.weight_q"], out[f"{prefix}.weight_scale"] = q, scale
    return out


def quant_matmul_reference(x2d: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version (``_xla_matmul_w8``, then ``QuantDense``'s bias): fp32
    product of x (M, K) with the int8 values, times the scale, rounded to x's
    dtype; then the bias in x's dtype added and the sum rounded again."""
    acc = x2d.float() @ q.float().t()
    y = (acc * scale.float()[None, :]).to(x2d.dtype)
    return y if bias is None else y + bias.to(x2d.dtype)


def quant_matmul_tf32_reference(x2d: torch.Tensor, q: torch.Tensor,
                                scale: torch.Tensor,
                                bias: Optional[torch.Tensor] = None,
                                products: int = 2,
                                k_tile: Optional[int] = None,
                                splits: int = 1,
                                drop_split: Optional[int] = None
                                ) -> torch.Tensor:
    """The fp32 kernel's split in plain fp32 torch: x = hi + lo, hi =
    tf32(x), lo = tf32(x - hi) (``round_tf32``, cvt.rna), and ``x q^T`` as
    ``lo q^T + hi q^T`` (the int8 values are exact in TF32); then the scale
    and the bias as :func:`quant_matmul_reference`.  ``products=1`` drops
    the lo product: what TF32 alone would compute (a mutant).  With
    ``k_tile``, the kernel's order of sums (:func:`w8_fp32_plan`'s
    ``block_k`` and ``splits``): each k tile's two products summed from
    zero and added, lo + hi, the tiles of a split added in order to the
    split's sum, the
    ``splits`` sums (ceil(tiles / splits) tiles each) added in split order;
    ``drop_split`` leaves that split's sum out (a mutant)."""
    hi = round_tf32(x2d)
    lo = round_tf32(x2d.float() - hi)
    qf = q.float().t()

    def product(cols):
        acc = hi[:, cols] @ qf[cols]
        return (lo[:, cols] @ qf[cols]) + acc if products == 2 else acc

    if k_tile is None:
        acc = product(slice(None))
    else:
        k_tiles = -(-x2d.shape[1] // k_tile)
        per = -(-k_tiles // splits)
        acc = torch.zeros((x2d.shape[0], q.shape[0]), device=x2d.device)
        for z in range(splits):
            part = torch.zeros_like(acc)
            for i in range(z * per, min(k_tiles, (z + 1) * per)):
                part = part + product(slice(i * k_tile, (i + 1) * k_tile))
            if z != drop_split:
                acc = acc + part
    y = acc * scale.float()[None, :]
    return y if bias is None else y + bias.float()


# the fp32 kernel's tile of y (csrc/quant_fp32_sm90.cu: 64 or 128 tokens x
# 128 features a block, K in tiles of 32, each tile's tensor-core sum from
# zero); 128 tokens where M >= FP32_WIDE_M or the 128-token tiles still
# fill the card's SMs (measured with tools/tune_w8_splits.py on an H100: 20%
# faster at M = 4096, at (1024, 640, 5120) and (256, 1280, 10240); slower
# where they leave SMs idle)
FP32_BLOCK_N, FP32_BLOCK_K, FP32_WIDE_M = 128, 32, 2048
# K is split (over blockIdx.z, merged in split order) where the output
# tiles leave SMs idle, as far as the blocks fit one wave (a block fills an
# SM; on an H100 a second, partial wave cost more than the split gained),
# each split at least FP32_MIN_TILES_PER_SPLIT k tiles (fewer lost to the
# merge), at most FP32_MAX_SPLITS (measured with tools/tune_w8_splits.py)
FP32_MIN_TILES_PER_SPLIT, FP32_MAX_SPLITS = 8, 16


def w8_fp32_split_limit(k: int) -> int:
    """The most K splits the fp32 plan takes at depth ``k``."""
    return max(1, min(FP32_MAX_SPLITS,
                      -(-k // FP32_BLOCK_K) // FP32_MIN_TILES_PER_SPLIT))


@functools.lru_cache(maxsize=None)
def w8_fp32_plan(m: int, n: int, k: int, splits: Optional[int] = None,
                 tokens_per_block: Optional[int] = None) -> dict:
    """The fp32 kernel's grid for (M, K) x (N, K)^T, in plain Python: 64
    tokens (128 from ``FP32_WIDE_M`` rows, or where 128-token tiles fill
    the card's SMs) x 128 features of y a block (``block_m`` x
    ``FP32_BLOCK_N``), K in tiles of ``FP32_BLOCK_K``, split as many ways
    as the tiles leave room for in one wave of the card's SMs (at most
    :func:`w8_fp32_split_limit`); no split is empty.  ``splits`` and
    ``tokens_per_block`` override the choice (for tuning)."""
    wide = -(-m // 128) * -(-n // FP32_BLOCK_N)
    bt = tokens_per_block or (128 if m >= FP32_WIDE_M or wide >= _SMS
                              else 64)
    if bt not in (64, 128):
        raise ValueError(f"tokens_per_block is 64 or 128; got {bt}")
    tiles = -(-m // bt) * -(-n // FP32_BLOCK_N)
    k_tiles = -(-k // FP32_BLOCK_K)
    if splits is None:
        splits = min(max(1, _SMS // tiles), w8_fp32_split_limit(k))
    if not 1 <= splits <= k_tiles:
        raise ValueError(f"splits is 1 to {k_tiles} at K {k}; got {splits}")
    per = -(-k_tiles // splits)
    splits = -(-k_tiles // per)  # no empty split
    return dict(block_m=bt, block_n=FP32_BLOCK_N, block_k=FP32_BLOCK_K,
                k_tiles=k_tiles, tiles_per_split=per, tiles=tiles,
                splits=splits, blocks=tiles * splits)


def pack_w8_weight(q: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 -> contiguous (ceil(K/64), 2*ceil(N/128), 4096) uint8, the
    kernel's A fragments: ``q + 128`` (0 past N and K reads as 128), and for
    each 64-wide k step and 64-feature tile the 128 consumer threads' 2 x 16
    bytes in thread order.  Thread ``lane = 4g + t`` of warp ``w`` reads
    features ``16w + g`` (first 16 bytes) and ``16w + g + 8`` (second), each
    as k ``16kk + (2t, 2t+1, 2t+8, 2t+9)`` for kk = 0..3: the bf16 register
    A operand of ``wgmma`` after conversion."""
    if q.dim() != 2 or q.dtype != torch.int8:
        raise ValueError(f"q must be (N, K) int8; got {q.dtype} "
                         f"{tuple(q.shape)}")
    n, k = q.shape
    f_tiles = 2 * -(-n // FEATURES_PER_BLOCK)
    k_steps = -(-k // K_STEP)
    qb = torch.nn.functional.pad(q.to(torch.int16) + 128,
                                 (0, k_steps * K_STEP - k, 0,
                                  f_tiles * 64 - n), value=128)
    # features (tile, w, half, g), k (step, kk, hb, t, e) -> (step, tile, w,
    # half, g, t, kk, hb, e)
    qb = qb.reshape(f_tiles, 4, 2, 8, k_steps, 4, 2, 4, 2)
    qb = qb.permute(4, 0, 1, 2, 3, 7, 5, 6, 8)
    return qb.reshape(k_steps, f_tiles, 4096).to(torch.uint8).contiguous()


@functools.lru_cache(maxsize=None)
def w8_plan(m: int, n: int, k: int, splits: Optional[int] = None,
            tokens_per_block: Optional[int] = None) -> dict:
    """The kernel's grid for (M, K) x (N, K)^T, in plain Python: tokens a
    block (128 where M >= 2048 or N >= 4096, else 64: the faster of the two
    at every UNet layer, measured with tools/tune_w8_splits.py), 128
    features a block, and the number of K splits.  A split sends its fp32
    partial tile through L2 and back, so it pays only where K is deep and
    the output tiles leave the card's SMs idle; no split is empty.
    ``splits`` and ``tokens_per_block`` override the choice (for tuning)."""
    bt = tokens_per_block or (128 if m >= 2048 or n >= 4096 else 64)
    if bt not in (64, 128):
        raise ValueError(f"tokens_per_block is 64 or 128; got {bt}")
    tiles = -(-m // bt) * -(-n // FEATURES_PER_BLOCK)
    k_steps = -(-k // K_STEP)
    if splits is None:
        splits = 1
        if k_steps >= _MIN_K_STEPS_TO_SPLIT:
            splits = max(1, min(_SMS // tiles, k_steps // 2, _MAX_SPLITS))
        splits = -(-k_steps // -(-k_steps // splits))  # no empty split
    return dict(tokens_per_block=bt, tiles=tiles, k_steps=k_steps,
                splits=splits, blocks=tiles * splits)


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 splits: Optional[int] = None,
                 tokens_per_block: Optional[int] = None,
                 packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) @ dequant(q (N, K), scale (N,))^T -> (..., N) in x's dtype,
    rounded, then ``+ bias`` (N,) in x's dtype and rounded again.

    CUDA: checks and launches the int8-read kernel for x's dtype on the
    current stream (raises on anything it does not take).  bf16 x: ``packed``
    is ``pack_w8_weight(q)``, made once by the caller (packed here without
    it); ``splits`` and ``tokens_per_block`` override :func:`w8_plan` (for
    tuning).  fp32 x: the kernel reads ``q`` as it is, so ``packed`` must
    be None; ``splits`` and ``tokens_per_block`` override
    :func:`w8_fp32_plan`.  CPU: the plain version.
    Kernel launches are counted in ``quant_matmul.launches``."""
    n, k = q.shape
    if (x.shape[-1] != k or scale.shape != (n,) or q.dtype != torch.int8
            or (bias is not None and bias.shape != (n,))):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q {q.dtype} "
                         f"{tuple(q.shape)}, scale {tuple(scale.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    x2d = x.reshape(-1, k)
    if x.device.type == "cpu":
        return quant_matmul_reference(x2d, q, scale, bias).reshape(
            *x.shape[:-1], n)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the int8 matmul kernels take bf16 or fp32 x; got "
                         f"{x.dtype}")
    if scale.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"scale must be bf16 or fp32; got {scale.dtype}")
    if k % 16 or x2d.shape[0] == 0:
        raise ValueError(f"the int8 matmul kernel takes K % 16 == 0 with at "
                         f"least one row; got M {x2d.shape[0]}, K {k}")
    x2d = x2d.contiguous()
    if bias is not None:
        bias = bias.to(x.dtype)  # the layer adds it in x's dtype
    if x.dtype == torch.float32:
        return _quant_matmul_fp32(x, x2d, q, scale, bias, packed, splits,
                                  tokens_per_block)
    if packed is None:
        packed = pack_w8_weight(q)
    m = x2d.shape[0]
    plan = w8_plan(m, n, k, splits, tokens_per_block)
    packed_shape = (plan["k_steps"], 2 * -(-n // FEATURES_PER_BLOCK), 4096)
    if packed.shape != packed_shape or packed.dtype != torch.uint8:
        raise ValueError(f"packed must be uint8 {packed_shape} "
                         f"(pack_w8_weight); got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    for name, t, align in (("x", x2d, 16), ("packed", packed, 16),
                           ("scale", scale, 4), ("bias", bias, 2)):
        if t is not None and (t.device != x.device or not t.is_contiguous()
                              or t.data_ptr() % align):
            raise ValueError(f"{name} must be contiguous and {align}-byte "
                             f"aligned on {x.device}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    splits, bt = plan["splits"], plan["tokens_per_block"]
    workspace = tickets = None
    if splits > 1:
        # one fp32 value per consumer thread's accumulator, per split, tile
        workspace = torch.empty(splits * plan["tiles"] * 256 * (bt // 2),
                                dtype=torch.float32, device=x.device)
        tickets = stream_tickets(x.device, plan["tiles"])
    _launch("w8_matmul_bf16", x2d.data_ptr(), packed.data_ptr(),
            scale.data_ptr(), int(scale.dtype == torch.bfloat16),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            workspace.data_ptr() if splits > 1 else None,
            tickets.data_ptr() if splits > 1 else None, m, n, k, bt, splits,
            torch.cuda.current_stream(x.device).cuda_stream)
    quant_matmul.launches += 1
    quant_matmul.flops += 2 * m * n * k
    return y.reshape(*x.shape[:-1], n)


def _quant_matmul_fp32(x, x2d, q, scale, bias, packed, splits,
                       tokens_per_block):
    if packed is not None:
        raise ValueError("the fp32 int8 kernel reads q as it is: packed is "
                         "for bf16 x")
    m, n, k = x2d.shape[0], q.shape[0], q.shape[1]
    for name, t, align in (("x", x2d, 16), ("q", q, 16), ("scale", scale, 4),
                           ("bias", bias, 4)):
        if t is not None and (t.device != x.device or not t.is_contiguous()
                              or t.data_ptr() % align):
            raise ValueError(f"{name} must be contiguous and {align}-byte "
                             f"aligned on {x.device}")
    plan = w8_fp32_plan(m, n, k, splits, tokens_per_block)
    splits, bt = plan["splits"], plan["block_m"]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    workspace = tickets = None
    if splits > 1:
        # each consumer thread's bt / 2 sums, per split and output tile
        workspace = torch.empty(splits * plan["tiles"] * 256 * (bt // 2),
                                dtype=torch.float32, device=x.device)
        tickets = stream_tickets(x.device, plan["tiles"])
    _launch("w8_matmul_fp32", x2d.data_ptr(), q.data_ptr(), scale.data_ptr(),
            int(scale.dtype == torch.bfloat16),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            None if tickets is None else tickets.data_ptr(), m, n, k, bt,
            splits, torch.cuda.current_stream(x.device).cuda_stream)
    quant_matmul.launches += 1
    quant_matmul.flops += 2 * m * n * k
    return y.reshape(*x.shape[:-1], n)


quant_matmul.launches = 0
# matrix-product FLOPs of the launches (edit_profiled reads it)
quant_matmul.flops = 0
