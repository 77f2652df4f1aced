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

``quant_matmul`` computes ``y = (x @ q^T) * scale`` without a dequantised
matrix.  On a CUDA tensor it launches the kernel or raises (bf16 x,
``K % 16 == 0``, ``N % 2 == 0``; the TPU kernel's ``N % 128`` gate is gone);
on a CPU tensor it computes the plain version.  Inference only: no gradient
is defined, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch

from diffute_tpu_torch.ops.flash_attention import _launch
from diffute_tpu_torch.ops.groupnorm import stream_tickets

# blocks the matmul aims to put on the card when it splits K (four per SM)
_TARGET_BLOCKS = 528
_MAX_SPLITS = 4
_MIN_K_STEPS_TO_SPLIT = 40
_tickets = {}  # (device, stream) -> zeroed int32 ticket counters


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
                           scale: torch.Tensor) -> torch.Tensor:
    """Plain version (``_xla_matmul_w8``): fp32 product of x (M, K) with the
    int8 values, times the scale, rounded to x's dtype."""
    acc = x2d.float() @ q.float().t()
    return (acc * scale.float()[None, :]).to(x2d.dtype)


def _choose_splits(m: int, n: int, k: int) -> int:
    """How many ways the kernel splits K's 64-wide steps.  A split sends its
    fp32 partial tile through L2 and back, so it pays only where K is deep
    and the 64 x 64 output tiles are too few to fill the card: measured with
    ``tools/tune_w8_splits.py`` on an H100, 3 to 4 splits cut the K = 5120
    layers at M = 64 and 256 by a third and the K = 2560 layer at M = 1024 by
    a seventh, and every split of a K <= 1280 layer is a loss."""
    tiles, k_steps = -(-m // 64) * -(-n // 64), -(-k // 64)
    if k_steps < _MIN_K_STEPS_TO_SPLIT:
        return 1
    splits = max(1, min(_TARGET_BLOCKS // tiles, _MAX_SPLITS))
    return -(-k_steps // -(-k_steps // splits))  # no empty split


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 splits: Optional[int] = None) -> torch.Tensor:
    """x (..., K) @ dequant(q (N, K), scale (N,))^T -> (..., N) in x's dtype.

    CUDA: checks and launches the int8-read kernel on the current stream
    (raises on anything it does not take); ``splits`` overrides the number of
    K splits the wrapper would choose (for tuning).  CPU: the plain version.
    Kernel launches are counted in ``quant_matmul.launches``."""
    n, k = q.shape
    if x.shape[-1] != k or scale.shape != (n,) or q.dtype != torch.int8:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q {q.dtype} "
                         f"{tuple(q.shape)}, scale {tuple(scale.shape)}")
    x2d = x.reshape(-1, k)
    if x.device.type == "cpu":
        return quant_matmul_reference(x2d, q, scale).reshape(*x.shape[:-1], n)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the int8 matmul kernel takes bf16 x; got {x.dtype}")
    if scale.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"scale must be bf16 or fp32; got {scale.dtype}")
    if k % 16 or n % 2 or x2d.shape[0] == 0:
        raise ValueError(f"the int8 matmul kernel takes K % 16 == 0 and even "
                         f"N with at least one row; got M {x2d.shape[0]}, "
                         f"K {k}, N {n}")
    x2d = x2d.contiguous()
    for name, t, align in (("x", x2d, 16), ("q", q, 16), ("scale", scale, 4)):
        if (t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % align):
            raise ValueError(f"{name} must be contiguous and {align}-byte "
                             f"aligned on {x.device}")
    m = x2d.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    tiles = -(-m // 64) * -(-n // 64)
    if splits is None:
        splits = _choose_splits(m, n, k)
    workspace = tickets = None
    if splits > 1:
        workspace = torch.empty((splits, m, n), dtype=torch.float32,
                                device=x.device)
        tickets = stream_tickets(_tickets, x.device, tiles)
    _launch("w8_matmul_bf16", x2d.data_ptr(), q.data_ptr(), scale.data_ptr(),
            int(scale.dtype == torch.bfloat16), y.data_ptr(),
            workspace.data_ptr() if splits > 1 else None,
            tickets.data_ptr() if splits > 1 else None, m, n, k, splits,
            torch.cuda.current_stream(x.device).cuda_stream)
    quant_matmul.launches += 1
    quant_matmul.flops += 2 * m * n * k
    return y.reshape(*x.shape[:-1], n)


quant_matmul.launches = 0
# matrix-product FLOPs of the launches (edit_profiled reads it)
quant_matmul.flops = 0
