"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``diffute_tpu/ops/flash_attention.py``: the forward
(``_flash_fwd_3d`` + ``_fwd_kernel`` -> ``csrc/flash_fwd.cu``), the
deferred-softmax forward behind the ``PIPELINE_FWD`` switch
(``_flash_fwd_3d_pipelined`` + ``_fwd_kernel_pipelined`` ->
``csrc/flash_fwd_pipelined.cu``) and the
backward (``_flash_bwd_3d`` + ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` ->
``csrc/flash_bwd.cu``), joined by :class:`FlashAttentionFn` as the JAX
package joins them with ``jax.custom_vjp``.  Those take head_dim 64 (the
UNet's heads); at head_dim 512 (the VAE mid-block's single head at SD2
width) the four are ``csrc/flash_wide.cu``; at 256 (``small_config``'s)
both forwards are ``csrc/flash_d256_sm90.cu`` and the two backward kernels
``csrc/flash_d256_bwd_sm90.cu`` (TMA and ``wgmma``, as at 64).  Those take
bf16.  On fp32 inputs both forwards at 64 are ``csrc/flash_fp32.cu``
(3xTF32 products, accurate to fp32); the backward pair at 64 is
``csrc/flash_fp32_d64_bwd_sm90.cu`` (tf32 ``wgmma`` on hi and lo planes
that a producer warpgroup splits once a TMA-fed 32-row tile); at 256 both
forwards are ``csrc/flash_fp32_d256_sm90.cu`` and the backward pair
``csrc/flash_fp32_d256_bwd_sm90.cu`` (the same schedule on each block of a
cluster of four over head_dim, the partial scores exchanged through
distributed shared memory and summed by one piece of code for all four,
``csrc/flash_fp32_d256_sm90.cuh``); at 512 both forwards are
``csrc/flash_fp32_d512_sm90.cu`` and the
backward pair ``csrc/flash_fp32_d512_bwd_sm90.cu`` (a cluster of four
blocks over head_dim, 64 resident rows, TMA-fed 32-row tiles, the same
products); all
compute the JAX package's fp32 arithmetic: the standard forward and the
backward in the natural domain with the exact scale after the product, the
deferred forward on q prescaled by ``scale * log2 e`` in base 2.  Every
other head_dim that is a multiple of 8 up to 128 (the tiny model's 8 and
16, SD1.x's 40 and 80, 128) takes ``csrc/flash_narrow.cu``'s four kernels,
bf16 or fp32, each at the smallest tile width of :data:`NARROW_WIDTHS`
that holds it, with the arithmetic of the other entries of its dtype; but
all four bf16 kernels at width 16 (head_dims 8 and 16, the tiny model's)
are ``csrc/flash_narrow_w16_sm90.cu``, sized to D, whose every
exponential is one MUFU instruction: both forwards, one kernel on a flag,
on blocks of :data:`NARROW_W16_FWD_ROWS` query rows, and the backward
pair on blocks of :data:`NARROW_W16_BWD_ROWS` query rows (dq) or kv rows
(dk/dv).
Every kernel reads its (batch, seq, heads, D) inputs, all bf16 or all
fp32, D as :func:`kernel_takes` says, through their strides (TMA at bf16
head_dim 64 and 256, in the fp32 backward pairs at 64 and 256 and in the
fp32 kernels at 512, cp.async elsewhere),
so the callers hand them the views they have, and writes its outputs
contiguous in that layout: no copy is made in either direction, and no
padded one at the narrow widths (the kernels zero-fill the columns past D
on chip).  Every LSE is natural-log fp32 (batch*heads, seq).

On a CUDA tensor every wrapper launches its kernel or raises; none falls
back.  On a CPU tensor it computes the plain version, at any head_dim,
which is what the CPU tests compare against the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# Route forwards whose kv length is a whole number (>= 2) of kv tiles through
# the deferred-softmax kernel (the tile by head_dim: pipelined_block_kv).
# Module-level, off by default, as in the JAX package: the switch exists so
# the two forwards can be timed in turns.
PIPELINE_FWD = False
# the kv tile of csrc/flash_fwd_pipelined.cu
PIPELINED_BLOCK_KV = 64
# the head_dims with kernels of their own, and the rows of every tile of
# csrc/flash_wide.cu (kRows there), which serves 512
HEAD_DIMS = (64, 256, 512)
WIDE_BLOCK_KV = 32
D512_BLOCK_KV = WIDE_BLOCK_KV  # the name before head_dim 256 was ported
# the kv tile both bf16 forwards at head_dim 256 walk (csrc/flash_d256_sm90.cu:
# kBlockKV there)
D256_FWD_BLOCK_KV = 64
# the bf16 backward at head_dim 256 (csrc/flash_d256_bwd_sm90.cu): the kv
# tile the dq kernel walks (kBlockKV there) and the kv rows a dk/dv block
# owns (kRows)
D256_BWD_BLOCK_KV = 64
# the streamed tile of every fp32 kernel by head_dim: at 64 the rows of
# every tile of csrc/flash_fp32.cu's forwards (kRows there; the backward
# pair at 64 walks FP32_D64_BWD_BLOCK_KV); at 256 the tile of the streamed
# axis of all four kernels, both forwards (csrc/flash_fp32_d256_sm90.cu)
# and the backward pair (csrc/flash_fp32_d256_bwd_sm90.cu): the kv tile of
# the forwards and dq, the q tile of dk/dv (kBlockKV of
# csrc/flash_fp32_d256_sm90.cuh); at 512 the tile
# of the streamed axis of all four kernels, both forwards
# (csrc/flash_fp32_d512_sm90.cu) and the backward pair
# (csrc/flash_fp32_d512_bwd_sm90.cu): the kv tile of the forwards and dq,
# the q tile of dk/dv (kBlockKV of csrc/flash_fp32_d512_sm90.cuh)
FP32_BLOCK_KV = {64: 64, 256: 32, 512: 32}
# the fp32 backward pair at head_dim 64 (csrc/flash_fp32_d64_bwd_sm90.cu):
# the kv tile the dq kernel walks and the q tile the dk/dv kernel walks
# (kBlockKV there)
FP32_D64_BWD_BLOCK_KV = 32
# the resident rows of a cluster of four blocks in the fp32 kernels at 512
# (kRows there): q rows of the forwards and dq, kv rows of dk/dv
FP32_D512_ROWS = 64
# the resident rows of a cluster of four blocks in the fp32 kernels at 256
# (kRows of csrc/flash_fp32_d256_sm90.cuh: q rows of the forwards and dq,
# kv rows of dk/dv) and its blocks (kRanks), each owning 256 /
# FP32_D256_RANKS columns of head_dim
FP32_D256_ROWS = 64
FP32_D256_RANKS = 4
# the tile widths of csrc/flash_narrow.cu, which takes every other head_dim
# that is a multiple of 8 up to 128 at the smallest width that holds it,
# and the rows of every tile there by width (kRows), both dtypes; the four
# bf16 kernels at width 16 (csrc/flash_narrow_w16_sm90.cu) walk the same
# kv tile (kBlockKV there; the q tile of dk/dv) with NARROW_W16_FWD_ROWS
# query rows a block (both forwards) and NARROW_W16_BWD_ROWS query rows (dq)
# or kv rows (dk/dv) a block (kRows there)
NARROW_WIDTHS = (16, 32, 64, 128)
NARROW_BLOCK_KV = {16: 64, 32: 64, 64: 32, 128: 32}
NARROW_W16_FWD_ROWS = 64
NARROW_W16_BWD_ROWS = 128
HEAD_DIM_RULE = "D = 64, 256, 512 or a multiple of 8 up to 128"
# the input dtypes the kernels take
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def set_pipeline_fwd(on: bool) -> bool:
    """Set ``PIPELINE_FWD``; return what it was.  (``diffute_tpu_torch.ops``
    exports the function ``flash_attention`` under this module's name, so
    ``ops.flash_attention.PIPELINE_FWD = ...`` would miss the module.)"""
    global PIPELINE_FWD
    was, PIPELINE_FWD = PIPELINE_FWD, bool(on)
    return was


def kernel_takes(head_dim: int) -> bool:
    """The head_dims a kernel takes (:data:`HEAD_DIM_RULE`): 64, 256 and 512,
    each with kernels of its own, and every multiple of 8 up to 128
    (``csrc/flash_narrow.cu``)."""
    return head_dim in HEAD_DIMS or (0 < head_dim <= NARROW_WIDTHS[-1]
                                     and head_dim % 8 == 0)


def narrow_width(head_dim: int) -> Optional[int]:
    """The tile width of ``csrc/flash_narrow.cu`` that runs ``head_dim``,
    the smallest of :data:`NARROW_WIDTHS` that holds it; None at 64, 256
    and 512 (their own kernels) and where no kernel takes it."""
    if head_dim in HEAD_DIMS or not kernel_takes(head_dim):
        return None
    return next(w for w in NARROW_WIDTHS if w >= head_dim)


# the four kernels of each head_dim and dtype
KINDS = ("fwd", "fwd_pipelined", "bwd_dq", "bwd_dkv")


def kernel_block_kv(head_dim: int, dtype: torch.dtype,
                    kind: Optional[str] = None) -> int:
    """The rows of the kv tile the ``kind`` kernel (:data:`KINDS`) at
    ``head_dim`` on ``dtype`` inputs walks in (what the tiled plain versions
    take to match it).  Without ``kind``, the tile all four walk; raises
    where they differ (the bf16 kernels at 256 walk
    :data:`D256_FWD_BLOCK_KV` forward and :data:`D256_BWD_BLOCK_KV`
    backward; the fp32 kernels walk :data:`FP32_BLOCK_KV` at every width
    but the backward pair at 64, which walks
    :data:`FP32_D64_BWD_BLOCK_KV`)."""
    if kind is None:
        tiles = {kernel_block_kv(head_dim, dtype, k) for k in KINDS}
        if len(tiles) > 1:
            raise ValueError(f"the kernels at head_dim {head_dim} on {dtype} "
                             f"walk kv tiles {sorted(tiles)}: name the kind")
        return tiles.pop()
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}; got {kind!r}")
    width = narrow_width(head_dim)
    if width is not None:
        return NARROW_BLOCK_KV[width]
    if dtype == torch.float32:
        if head_dim == 64 and kind.startswith("bwd"):
            return FP32_D64_BWD_BLOCK_KV
        return FP32_BLOCK_KV[head_dim]
    if head_dim == 256:
        return (D256_FWD_BLOCK_KV if kind.startswith("fwd")
                else D256_BWD_BLOCK_KV)
    return WIDE_BLOCK_KV if head_dim == 512 else PIPELINED_BLOCK_KV


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


# The arithmetic domains of the forward's plain version: "base2" the bf16
# kernels' (``q k^T * scale * log2 e`` after the product, exp2), "natural"
# the JAX package's fp32 standard kernel's (``q k^T * scale``, exp, the LSE
# ``m + log l``), "prescaled" its deferred kernel's (q multiplied by
# ``scale * log2 e`` and rounded to q's dtype first, exp2).
DOMAINS = ("base2", "natural", "prescaled")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``): what one TF32 product would
    make of its operands.  The plain versions' ``tf32`` mutant uses it."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _operand(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    return round_tf32(x) if tf32 else x.float()


def flash_fwd_tiled_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float,
                              block_kv: int = PIPELINED_BLOCK_KV,
                              domain: Optional[str] = None,
                              tf32: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernels' arithmetic, kv tile by kv
    tile: fp32 score tiles, running max and sum, ``p`` rounded to ``v``'s
    dtype before ``p v``, and a natural-log LSE.  Any T: the last tile may
    be short (the kernels mask its columns past T).

    ``domain`` (:data:`DOMAINS`; by default "base2" on bf16 inputs and
    "natural" on fp32, the JAX package's rule for its standard kernel):
    "base2" scales the scores by ``scale * log2 e`` after the product, as
    the bf16 kernels' FMA does, and converts the LSE at the end; the bf16
    kernels round ``p`` against the running max, so this, not the one-pass
    :func:`flash_attention_reference`, is what they match to a few bf16
    ulps.  "natural" and "prescaled" are the fp32 kernels'
    (``csrc/flash_fp32.cu``; at 256 and 512
    ``csrc/flash_fp32_d{256,512}_sm90.cu``).
    ``tf32``: round every product's operands to TF32 first (a mutant: what
    TF32 alone would compute).

    q (BH, S, D), k/v (BH, T, D) -> (o (BH, S, D) in q's dtype,
    lse (BH, S) fp32)."""
    if domain is None:
        domain = "natural" if q.dtype == torch.float32 else "base2"
    if domain not in DOMAINS:
        raise ValueError(f"domain must be one of {DOMAINS}; got {domain!r}")
    bh, s_len, d = q.shape
    qf, c = q.float(), scale * _LOG2E
    if domain == "prescaled":
        qf = (qf * c).to(q.dtype).float()
    qf = _operand(qf, tf32)
    exp = torch.exp if domain == "natural" else torch.exp2
    m = torch.full((bh, s_len, 1), -torch.inf, device=q.device)
    l = torch.zeros((bh, s_len, 1), device=q.device)
    acc = torch.zeros((bh, s_len, d), device=q.device)
    for j in range(0, k.shape[1], block_kv):
        s_j = torch.einsum("bsd,btd->bst", qf,
                           _operand(k[:, j:j + block_kv], tf32))
        if domain != "prescaled":
            s_j = s_j * (scale if domain == "natural" else c)
        m_new = torch.maximum(m, s_j.amax(dim=-1, keepdim=True))
        alpha = exp(m - m_new)
        p = exp(s_j - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bst,btd->bsd", _operand(p.to(v.dtype), tf32),
            _operand(v[:, j:j + block_kv], tf32))
        m = m_new
    lse = m + torch.log(l) if domain == "natural" else (
        (m + torch.log2(l)) * _LN2)
    return (acc / l).to(q.dtype), lse[..., 0]


def pipelined_block_kv(head_dim: int) -> int:
    """The kv tile of the deferred-softmax kernel at ``head_dim`` that the
    dispatch rule counts in: :data:`D256_FWD_BLOCK_KV` at 256
    (``csrc/flash_d256_sm90.cu``), 32 at 512 (``csrc/flash_wide.cu``), 64
    at any other (``csrc/flash_fwd_pipelined.cu`` at 64, and every narrow
    width).  The fp32 kernels' tiles (:data:`FP32_BLOCK_KV`: 64, 32, 32)
    and the narrow ones (:data:`NARROW_BLOCK_KV`: 64 or 32) divide it, so
    they take every T the rule takes, at every width."""
    if head_dim == 256:
        return D256_FWD_BLOCK_KV
    return WIDE_BLOCK_KV if head_dim == 512 else PIPELINED_BLOCK_KV


def flash_fwd_pipelined_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, scale: float,
                                  block_kv: int = PIPELINED_BLOCK_KV,
                                  tf32: bool = False
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the deferred-softmax kernels.  A kernel issues tile
    ``j + 1``'s scores before tile ``j``'s softmax, which reorders the work
    and not the arithmetic: :func:`flash_fwd_tiled_reference`, restricted to
    the dispatch rule's T.  ``block_kv`` is the kernel's tile
    (:func:`pipelined_block_kv` of the head_dim).  The domain is "base2" on
    bf16 inputs (the bf16 kernels') and "prescaled" on fp32 (the JAX
    package's ``_flash_fwd_3d_pipelined``, as ``csrc/flash_fp32.cu`` and,
    at 256 and 512, ``csrc/flash_fp32_d{256,512}_sm90.cu`` compute it).

    q (BH, S, D), k/v (BH, T, D) with T a multiple of ``block_kv`` and at
    least two tiles -> (o (BH, S, D) in q's dtype, lse (BH, S) fp32)."""
    t_len = k.shape[1]
    if t_len % block_kv or t_len // block_kv < 2:
        raise ValueError(f"the pipelined forward takes T a multiple of "
                         f"{block_kv} with at least two tiles; got {t_len}")
    domain = "prescaled" if q.dtype == torch.float32 else "base2"
    return flash_fwd_tiled_reference(q, k, v, scale, block_kv, domain, tf32)


def check_tma_layout(x: torch.Tensor, name: str = "x") -> None:
    """Raise on a layout the kernels' loads (TMA at bf16 head_dim 64 and
    256 and in the fp32 kernels at 512, 16-byte cp.async elsewhere) cannot
    read: a last (head_dim) stride other than 1, another stride not a whole
    number of 16 bytes (8 bf16 or 4 fp32 elements), or a base not 16-byte
    aligned.
    Nothing is copied to make a layout fit."""
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the last stride must be 1, got "
                         f"{x.stride()}")
    step = 16 // x.element_size()
    if any(st % step for st in x.stride()[:-1]):
        raise ValueError(f"{name}: strides {x.stride()} are not multiples of "
                         f"{step} elements (16 bytes)")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: base address is not 16-byte aligned")


def _check_4d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              **more: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: (B, seq, H, D) tensors
    of one dtype, bf16 or fp32 (:data:`KERNEL_DTYPES`), D as
    :func:`kernel_takes` says, in a layout they read
    (:func:`check_tma_layout`); k and v of one shape, and of q's batch,
    heads and head_dim; ``more`` (o, dO) of q's shape; every tensor on q's
    CUDA device.  The device is checked last, so that on a ``meta`` tensor
    each other refusal shows."""
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
        if x.dtype not in KERNEL_DTYPES:
            raise ValueError(f"the flash kernels take bf16 or fp32; {name} "
                             f"is {x.dtype}")
        if x.dtype != q.dtype:
            raise ValueError(f"the flash kernels take one dtype; q is "
                             f"{q.dtype}, {name} is {x.dtype}")
        if x.dim() != 4 or not kernel_takes(x.shape[-1]):
            raise ValueError(f"the flash kernels take (B, seq, H, D) with "
                             f"{HEAD_DIM_RULE}; {name} is {tuple(x.shape)}")
        check_tma_layout(x, name)
    b, s_len, h, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != h
            or k.shape[3] != d or s_len == 0 or k.shape[1] == 0
            or any(x.shape != q.shape for x in more.values())):
        raise ValueError("shape mismatch: " + ", ".join(
            f"{n} {tuple(x.shape)}"
            for n, x in (("q", q), ("k", k), ("v", v), *more.items())))
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    for name, x in (("k", k), ("v", v), *more.items()):
        if x.device != q.device:
            raise ValueError(f"the flash kernels take every tensor on "
                             f"{q.device}; {name} is on {x.device}")


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


def _width_tag(head_dim: int) -> str:
    # "" at 64, "d256" / "d512", "w16" ... "w128" at the narrow widths
    width = narrow_width(head_dim)
    if width is not None:
        return f"w{width}"
    return "" if head_dim == 64 else f"d{head_dim}"


def kernel_name(kind: str, head_dim: int, dtype: torch.dtype) -> str:
    """The C entry of ``kind`` (:data:`KINDS`: "fwd", "fwd_pipelined",
    "bwd_dq" or "bwd_dkv") at ``head_dim`` on ``dtype`` inputs, e.g.
    ``flash_fwd_pipelined_d512_fp32``, or at a narrow head_dim its tile
    width's, e.g. ``flash_fwd_w16_bf16`` at 8 or 16."""
    tag = _width_tag(head_dim)
    return (f"flash_{kind}" + (f"_{tag}" if tag else "")
            + ("_fp32" if dtype == torch.float32 else "_bf16"))


def counter_name(kind: str, head_dim: int, dtype: torch.dtype) -> str:
    """The attribute of :func:`flash_attention` that counts the launches of
    :func:`kernel_name`'s entry, e.g. ``fp32_d512_pipelined_launches`` or
    ``w16_bwd_dq_launches`` (bf16 at head_dim 64: ``launches``,
    ``pipelined_launches``, ``bwd_dq_launches``, ``bwd_dkv_launches``)."""
    tag = _width_tag(head_dim)
    return (("fp32_" if dtype == torch.float32 else "")
            + (f"{tag}_" if tag else "")
            + {"fwd": "", "fwd_pipelined": "pipelined_"}.get(kind, kind + "_")
            + "launches")


# one head_dim for each set of entries: 64, 256, 512 and a head_dim of each
# narrow width (8, 24, 56, 120)
ENTRY_HEAD_DIMS = HEAD_DIMS + tuple(w - 8 for w in NARROW_WIDTHS)


def counter_names() -> list:
    """Every entry's launch counter (:func:`counter_name`), each once."""
    return [counter_name(kind, d, dtype) for kind in KINDS
            for d in ENTRY_HEAD_DIMS for dtype in KERNEL_DTYPES]


def _lengths(s_len: int, t_len: int, head_dim: int) -> tuple:
    """The entry's length arguments: S and T, and after them the head_dim
    for ``csrc/flash_narrow.cu``'s entries (the others know theirs)."""
    return (s_len, t_len) + ((head_dim,) if narrow_width(head_dim) else ())


def _count(kind: str, head_dim: int, dtype: torch.dtype) -> None:
    name = counter_name(kind, head_dim, dtype)
    setattr(flash_attention, name, getattr(flash_attention, name) + 1)


def _fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, pipelined: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a forward kernel on (B, S, H, D) q and (B, T, H, D) k, v as
    they lie, D as :func:`kernel_takes` says, bf16 or fp32: o comes back
    contiguous (B, S, H, D) in q's dtype, lse (B*H, S).  ``pipelined``: the
    deferred-softmax kernel of that head_dim and dtype.  Raises on anything
    the kernels do not take."""
    return _launch_fwd(q, k, v, scale, pipelined, 0)


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, pipelined: bool, consumers: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_fwd_kernel`; the bf16 head_dim-256 entries also take
    ``consumers``, the consumer warpgroups a block (0: their launcher's
    choice, :func:`d256_consumers`)."""
    _check_4d(q, k, v)
    b, s_len, h, d = q.shape
    t_len = k.shape[1]
    if pipelined and not _pipelined_takes(t_len, d):
        raise ValueError(f"the pipelined forward at head_dim {d} takes T a "
                         f"multiple of {pipelined_block_kv(d)} with at least "
                         f"two tiles; got {t_len}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b * h, s_len), dtype=torch.float32, device=q.device)
    name = kernel_name("fwd_pipelined" if pipelined else "fwd", d, q.dtype)
    layout = (consumers,) if d == 256 and q.dtype == torch.bfloat16 else ()
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, *_lengths(s_len, t_len, d),
            _strides(q, k, v, o), float(scale), _stream(q), *layout)
    _count_forward(q, k, pipelined)
    return o, lse


def d256_consumers(bh: int, s_len: int) -> int:
    """The consumer warpgroups a block (1: 64 q rows, 2: 128) that the
    launcher of the bf16 head_dim-256 forwards takes for B*H = ``bh`` and
    S = ``s_len`` on the current card: two where that gives every SM a
    block.  Needs the card (the rule reads its SM count)."""
    from diffute_tpu_torch.ops import _build

    return _build.load().flash_fwd_d256_consumers(bh, s_len)


def flash_fwd_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, consumers: int, pipelined: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_fwd`'s contract on bf16 (B, L, H, 256) CUDA tensors
    through the standard (or, ``pipelined``, the deferred) head_dim-256
    forward with ``consumers`` (1 or 2) consumer warpgroups a block,
    whichever the launcher would take by itself (:func:`d256_consumers`):
    each warpgroup computes its rows by the same instructions in either, so
    both give the same bits.  For the checks that hold the two layouts to
    each other; counted as the entry's launches.  Raises on anything
    else."""
    if (consumers not in (1, 2) or q.shape[-1] != 256
            or q.dtype != torch.bfloat16):
        raise ValueError(f"a block layout of 1 or 2 consumer warpgroups is "
                         f"the bf16 head_dim-256 forwards'; got {consumers} "
                         f"at head_dim {q.shape[-1]}, {q.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"the block layouts are the card's; q is on "
                         f"{q.device}")
    return _launch_fwd(q, k, v, scale, pipelined, consumers)


def _count_forward(q: torch.Tensor, k: torch.Tensor, pipelined: bool) -> None:
    """Count one forward launch on (B, S, H, D) q and (B, T, H, D) k: its
    counter by kernel, and its matrix-product FLOPs (4 B H S T D) in
    ``flash_attention.flops``."""
    b, s_len, h, d = q.shape
    _count("fwd_pipelined" if pipelined else "fwd", d, q.dtype)
    flash_attention.flops += 4 * b * h * s_len * k.shape[1] * d


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, H, D), k/v (B, T, H, D), D as :func:`kernel_takes` says,
    in any layout the kernels read (:func:`check_tma_layout`) ->
    (o (B, S, H, D) contiguous, lse (B*H, S)).  No copy of q, k or v is
    made.

    CUDA: the kernel of q's dtype (bf16 or fp32) and head_dim on the
    current stream: with ``PIPELINE_FWD`` set and T a whole number (>= 2)
    of the deferred-softmax kernel's kv tiles (:func:`pipelined_block_kv`:
    64 at 256 (:data:`D256_FWD_BLOCK_KV`), 32 at 512, 64 at every other
    head_dim), that kernel; otherwise
    the standard one.  CPU: the matching plain version, at any head_dim."""
    d = q.shape[-1]
    pipelined = PIPELINE_FWD and _pipelined_takes(k.shape[1], d)
    if q.device.type != "cpu":
        return _fwd_kernel(q, k, v, scale, pipelined)
    q3, k3, v3 = (_heads_first(x) for x in (q, k, v))
    if pipelined:
        o3, lse = flash_fwd_pipelined_reference(q3, k3, v3, scale,
                                                pipelined_block_kv(d))
    else:
        o3, lse = flash_attention_reference(q3, k3, v3, scale)
    return _heads_last(o3, q.shape[0], q.shape[2]), lse


def flash_fwd_3d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (BH, S, D), k/v (BH, T, D) -> (o (BH, S, D), lse (BH, S)):
    :func:`flash_fwd` with H = 1, so the same dispatch (``PIPELINE_FWD``)
    and the same checks (raises on anything the kernel does not take)."""
    o, lse = flash_fwd(*_as4d(q, k, v), scale)
    return o[:, :, 0], lse


def _as4d(*xs: torch.Tensor):
    for x in xs:
        if x.dim() != 3:
            raise ValueError(f"expected (BH, seq, D), got {tuple(x.shape)}")
    return tuple(x[:, :, None] for x in xs)


def _pipelined_takes(t_len: int, head_dim: int) -> bool:
    """The dispatch rule of ``PIPELINE_FWD``, as the JAX package's
    ``_flash_fwd_3d``: T a multiple of the kernel's kv tile with at least
    two tiles (the tile by head_dim: :func:`pipelined_block_kv`)."""
    block = pipelined_block_kv(head_dim)
    return t_len % block == 0 and t_len // block >= 2


def flash_fwd_3d_pipelined(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_fwd_3d`'s contract through the deferred-softmax kernel
    of q's head_dim; T must be a multiple of its kv tile
    (:func:`pipelined_block_kv`) with at least two tiles (raises otherwise:
    nothing is padded).

    CUDA: checks and launches the kernel on the current stream.  CPU: its
    plain version."""
    if q.device.type == "cpu":
        return flash_fwd_pipelined_reference(q, k, v, scale,
                                             pipelined_block_kv(q.shape[-1]))
    o, lse = _fwd_kernel(*_as4d(q, k, v), scale, pipelined=True)
    return o[:, :, 0], lse


def _scores(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
            scale: float) -> torch.Tensor:
    """p = exp(q k^T * scale - lse), fp32 (BH, S, T): the softmax recomputed
    from the saved LSE (the JAX package's fp32 arithmetic)."""
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
                              scale: float, block_kv: int = PIPELINED_BLOCK_KV,
                              tf32: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the backward kernels' arithmetic, kv tile by kv
    tile: delta = rowsum(dO * O) in fp32 from the saved o and dO, fp32 score
    tiles, ``ds = p * (dO v^T - delta)``, ``p`` (for dv) and ``ds`` (for dq
    and dk) rounded to the inputs' dtype before their products, the scale
    applied to dq and dk at the end.  Any T: the last tile may be short.

    On bf16 inputs (the bf16 kernels) ``p = exp2(s * scale * log2 e -
    lse * log2 e)``; the kernels round p and ds as this does, so this, not
    the one-pass :func:`flash_bwd_reference`, is what they match to a few
    bf16 ulps.  On fp32 inputs (the JAX package's fp32 kernels and the
    port's fp32 backward pairs) the natural domain: ``p = exp(s * scale -
    lse)``.  ``tf32``: round every product's operands to TF32 first (a
    mutant).

    q, o, do (BH, S, D), k/v (BH, T, D), lse (BH, S) -> (dq, dk, dv) in the
    inputs' dtypes."""
    c = scale * _LOG2E
    delta = _delta(o, do)[..., None]
    lse2 = lse[..., None] * _LOG2E
    qf, dof = _operand(q, tf32), _operand(do, tf32)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(0, k.shape[1], block_kv):
        kj = _operand(k[:, j:j + block_kv], tf32)
        vj = _operand(v[:, j:j + block_kv], tf32)
        s = torch.einsum("bsd,btd->bst", qf, kj)
        if q.dtype == torch.float32:
            p = torch.exp(s * scale - lse[..., None])
        else:
            p = torch.exp2(s * c - lse2)
        ds = p * (torch.einsum("bsd,btd->bst", dof, vj) - delta)
        dvs.append(torch.einsum("bst,bsd->btd",
                                _operand(p.to(do.dtype), tf32), dof))
        dks.append(torch.einsum("bst,bsd->btd",
                                _operand(ds.to(q.dtype), tf32), qf))
        dq += torch.einsum("bst,btd->bsd", _operand(ds.to(k.dtype), tf32), kj)
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
    """dq (B, S, H, D) contiguous and delta = rowsum(dO * O) (B*H, S) fp32,
    from (B, L, H, D) q, k, v, the forward's o and lse, and the incoming
    dO, in any layout the kernels read; D as :func:`kernel_takes` says,
    bf16 or fp32.  No copy is made.

    CUDA: the dq kernel of that head_dim and dtype on the current stream
    (it computes delta too); raises on anything it does not take.  CPU: the
    plain versions."""
    if q.device.type == "cpu":
        q3, k3, v3, o3, do3 = (_heads_first(x) for x in (q, k, v, o, do))
        delta = _delta(o3, do3)
        dq = flash_bwd_dq_reference(q3, k3, v3, do3, lse, delta, scale)
        return _heads_last(dq, q.shape[0], q.shape[2]), delta
    _check_4d(q, k, v, o=o, do=do)
    _check_stats(q, lse=lse)
    b, s_len, h, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((b * h, s_len), dtype=torch.float32, device=q.device)
    _launch(kernel_name("bwd_dq", d, q.dtype),
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, h, *_lengths(s_len, k.shape[1], d),
            _strides(q, k, v, o, do, dq), float(scale), _stream(q))
    _count("bwd_dq", d, q.dtype)
    return dq, delta


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv (B, T, H, D) contiguous from (B, L, H, D) q, k, v, dO in any
    layout the kernels read (D as :func:`kernel_takes` says, bf16 or fp32),
    the forward's lse and :func:`flash_bwd_dq`'s delta.

    CUDA: the dk/dv kernel of that head_dim and dtype on the current
    stream; raises on anything it does not take.  CPU: the plain
    version."""
    if q.device.type == "cpu":
        dk, dv = flash_bwd_dkv_reference(
            *(_heads_first(x) for x in (q, k, v, do)), lse, delta, scale)
        return (_heads_last(dk, k.shape[0], k.shape[2]),
                _heads_last(dv, v.shape[0], v.shape[2]))
    _check_4d(q, k, v, do=do)
    _check_stats(q, lse=lse, delta=delta)
    b, s_len, h, d = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch(kernel_name("bwd_dkv", d, q.dtype),
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, *_lengths(s_len, k.shape[1], d),
            _strides(q, k, v, do, dk, dv), float(scale), _stream(q))
    _count("bwd_dkv", d, q.dtype)
    return dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_fwd`'s o w.r.t. q, k, v: (B, L, H, D)
    inputs (D as :func:`kernel_takes` says, bf16 or fp32) in any layout the
    kernels read, the forward's o and lse, the incoming dO -> dq, dk, dv
    contiguous (B, L, H, D).  No copy is made.

    CUDA: the dq kernel (with delta), then the dk/dv kernel, on the current
    stream; raises on anything they do not take.  CPU: the plain
    versions."""
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, scale)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, scale))


def flash_bwd_dq_3d(q, k, v, o, lse, do, scale
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, S, D) q, o, dO and (BH, T, D) k, v -> (dq (BH, S, D),
    delta (BH, S)): :func:`flash_bwd_dq` with H = 1."""
    dq, delta = flash_bwd_dq(*_as4d(q, k, v, o), lse, *_as4d(do), scale)
    return dq[:, :, 0], delta


def flash_bwd_dkv_3d(q, k, v, do, lse, delta, scale
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv (BH, T, D): :func:`flash_bwd_dkv` with H = 1."""
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
    """(B, S, H, D) attention, D as :func:`kernel_takes` says, bf16 or fp32,
    whose forward and backward are the kernels.

    Both read the (B, L, H, D) views they are given through their strides
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
    kernels, all bf16 at head_dim 64; ``.d512_launches``,
    ``.d512_pipelined_launches``, ``.d512_bwd_dq_launches`` and
    ``.d512_bwd_dkv_launches`` the four bf16 kernels at head_dim 512, and
    ``.d256_*`` the same four at head_dim 256; ``.w16_*``, ``.w32_*``,
    ``.w64_*`` and ``.w128_*`` the same four of the narrow kernels by tile
    width (``.w16_launches`` counts the forwards at head_dim 8 and 16);
    ``.fp32_*`` every one of them on fp32 inputs (``.fp32_launches``,
    ``.fp32_d512_pipelined_launches``, ``.fp32_w16_bwd_dq_launches``, ...:
    :func:`counter_name`, all of them :func:`counter_names`).  The scale
    defaults to head_dim ** -0.5."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        # nothing to differentiate (serving, the frozen encoders): the
        # forward alone on the 4-D views, no copy in and o contiguous out
        # (so the caller's reshape to (B, S, H*D) is a view)
        return flash_fwd(q, k, v, scale)[0]
    return FlashAttentionFn.apply(q, k, v, scale)


# every kernel's launch counter (counter_names), and the matrix-product
# FLOPs of the forward launches at the real head_dim (edit_profiled reads
# it)
for _name in counter_names():
    setattr(flash_attention, _name, 0)
del _name
flash_attention.flops = 0
