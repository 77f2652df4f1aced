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
as it is); the fp32 kernel (``csrc/quant_fp32.cu``, two TF32 products: x
split as hi + lo, every int8 value exact in TF32) reads ``q`` as it is.
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
                                products: int = 2) -> torch.Tensor:
    """The fp32 kernel's split in plain fp32 torch: x = hi + lo, hi =
    tf32(x), lo = tf32(x - hi) (``round_tf32``, cvt.rna), and ``x q^T`` as
    ``lo q^T + hi q^T`` (the int8 values are exact in TF32); then the scale
    and the bias as :func:`quant_matmul_reference`.  ``products=1`` drops
    the lo product: what TF32 alone would compute (a mutant)."""
    hi = round_tf32(x2d)
    qf = q.float().t()
    acc = hi @ qf
    if products == 2:
        acc = (round_tf32(x2d.float() - hi) @ qf) + acc
    y = acc * scale.float()[None, :]
    return y if bias is None else y + bias.float()


# the fp32 kernel's tile of y (csrc/quant_fp32.cu: 64 x 64 a block, K in
# tiles of 32, no split)
FP32_BLOCK_M, FP32_BLOCK_N, FP32_BLOCK_K = 64, 64, 32


def w8_fp32_plan(m: int, n: int, k: int) -> dict:
    """The fp32 kernel's grid for (M, K) x (N, K)^T: a 64 x 64 tile of y
    a block (``FP32_BLOCK_M`` x ``FP32_BLOCK_N``), K walked in tiles of 32
    inside the block, never split."""
    tiles = -(-m // FP32_BLOCK_M) * -(-n // FP32_BLOCK_N)
    return dict(block_m=FP32_BLOCK_M, block_n=FP32_BLOCK_N,
                k_tiles=-(-k // FP32_BLOCK_K), tiles=tiles, splits=1,
                blocks=tiles)


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
    tuning).  fp32 x: the kernel reads ``q`` as it is, so ``packed``,
    ``splits`` and ``tokens_per_block`` must be None.  CPU: the plain
    version.  Kernel launches are counted in ``quant_matmul.launches``."""
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
    if any(a is not None for a in (packed, splits, tokens_per_block)):
        raise ValueError("the fp32 int8 kernel reads q as it is and has one "
                         "grid: packed, splits and tokens_per_block are for "
                         "bf16 x")
    m, n, k = x2d.shape[0], q.shape[0], q.shape[1]
    for name, t, align in (("x", x2d, 16), ("q", q, 16), ("scale", scale, 4),
                           ("bias", bias, 4)):
        if t is not None and (t.device != x.device or not t.is_contiguous()
                              or t.data_ptr() % align):
            raise ValueError(f"{name} must be contiguous and {align}-byte "
                             f"aligned on {x.device}")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _launch("w8_matmul_fp32", x2d.data_ptr(), q.data_ptr(), scale.data_ptr(),
            int(scale.dtype == torch.bfloat16),
            None if bias is None else bias.data_ptr(), y.data_ptr(), m, n, k,
            torch.cuda.current_stream(x.device).cuda_stream)
    quant_matmul.launches += 1
    quant_matmul.flops += 2 * m * n * k
    return y.reshape(*x.shape[:-1], n)


quant_matmul.launches = 0
# matrix-product FLOPs of the launches (edit_profiled reads it)
quant_matmul.flops = 0
