"""PyTorch port, flash attention at the narrow head_dims: every multiple of 8
up to 128 but 64 (``csrc/flash_narrow.cu``, tile widths 16, 32, 64 and 128;
the tiny model's UNet heads are 8 wide, its VAE mid-block's head 16).

On the CPU the same numpy-seeded inputs go through the JAX package's flash
attention (Pallas kernels in interpret mode, as tests/test_flash_attention.py
runs them: the forward and ``jax.vjp`` through it, and the deferred-softmax
``_flash_fwd_3d_pipelined``) and through the port's tiled plain versions at
the narrow kernels' kv tile, which the kernels are held to on the card, at
head_dims 8, 16, 40 and 128, bf16 and fp32, with a ragged T; then the
mutants the card's criteria must refuse, the wrappers' rule on meta
tensors (every narrow head_dim taken, 73, 136, 384 and 1024 refused) and
the entries' names and counters.  The CUDA kernels run only on a card:
their tests are marked ``cuda`` and skip elsewhere.  This file imports only
``diffute_tpu.ops`` of the JAX package, so the card's image (jax without
flax) runs its ``cuda`` tests.
"""

import functools
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffute_tpu.ops.flash_attention as jfa

from diffute_tpu_torch.ops import _build
from port_threads import torch_threads_per_worker  # noqa: F401

tfa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")

DIMS = (8, 16, 40, 128)
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
KINDS = ("fwd", "fwd_pipelined", "bwd_dq", "bwd_dkv")
# fp32: the precision contract of tests/test_torch_port_flash_fp32.py (both
# sides fp32, the sums in other orders): o, dq, dk, dv within relative L2
# 1e-5, the LSE within 1e-5
REL_L2, LSE_ABS = 1e-5, 1e-5
# bf16: JAX rounds q * (scale * log2 e) to bf16 before the product (its
# base-2 kernels), the port scales the fp32 score after it, and both round
# p (and ds) to bf16 against their own kv tiles (JAX one block of 384 keys
# here, the port 64 or 32): o within one bf16 ulp of its largest element
# (tests/test_torch_port_flash_wide_pipelined.py's bound; 0.55 to 0.74 of
# it read), the LSE within BF16_LSE_ABS (q's rounding moves a score by up to
# 2^-9 of sum |q_i k_i| * scale; 1.4e-3 to 4.7e-3 read), dq, dk and dv
# within relative L2 BF16_GRAD_REL_L2 (3.2e-3 to 4.5e-3 read)
BF16_LSE_ABS, BF16_GRAD_REL_L2 = 1e-2, 1e-2


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu()
    return torch.from_numpy(np.array(x, np.float32))


def _rel_l2(got, ref) -> float:
    got, ref = _f32(got), _f32(ref)
    return ((got - ref).norm() / ref.norm()).item()


def _inputs(seed, b, s, t, h, d):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d),
                               (b, s, h, d)))


# (B, S, T, H): T ragged against every narrow kv tile (64, 32), two heads;
# the deferred forward's (B*H, S, T): T two of JAX's 128-key blocks and a
# whole number of the port's 64 (the dispatch rule's tile at every narrow
# width)
SHAPE, DEFERRED = (1, 100, 300, 2), (1, 128, 256)


@functools.partial(jax.jit, static_argnums=(8,))
def _jax_programs(q, k, v, g, q3, k3, v3, scale, d):
    """One program (one compile) per head_dim and dtype: the JAX flash
    forward's o and LSE, the gradients of flash_attention through jax.vjp
    with the cotangent g, and the deferred-softmax kernel on (q3, k3, v3)
    at 128-row blocks."""
    del d
    out, (_, _, _, _, lse) = jfa._flash_fwd_rule(q, k, v, None, None, None)
    _, vjp = jax.vjp(jfa.flash_attention, q, k, v)
    return out, lse, vjp(g), jfa._flash_fwd_3d_pipelined(q3, k3, v3, scale,
                                                         128, 128)


@functools.lru_cache(maxsize=None)
def _jax_results(d, dtype):
    """_jax_programs on _inputs at SHAPE and DEFERRED in ``dtype``, in
    interpret mode; everything returned as fp32 numpy (the LSEs (B*H, S),
    natural log)."""
    jdt = DTYPES[dtype][1]
    q, k, v, g = (jnp.asarray(x, jdt) for x in _inputs(d, *SHAPE, d))
    q3, k3, v3 = (jnp.asarray(x[:, :, 0], jdt)
                  for x in _inputs(d + 1, *DEFERRED, 1, d)[:3])
    with pltpu.force_tpu_interpret_mode():
        out, lse, grads, (po, plse) = _jax_programs(q, k, v, g, q3, k3, v3,
                                                    d ** -0.5, d)
    return dict(o=np.asarray(out, np.float32), lse=np.asarray(lse)[..., 0],
                grads=tuple(np.asarray(x, np.float32) for x in grads),
                deferred=(np.asarray(po, np.float32),
                          np.asarray(plse)[..., 0]))


def _to3d(x, dtype):
    return tfa._to3d(torch.from_numpy(np.array(x))).to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", DIMS)
def test_tiled_plain_versions_match_jax(d, dtype):
    tdt = DTYPES[dtype][0]
    jax_res = _jax_results(d, dtype)
    j_out, j_lse, j_grads = jax_res["o"], jax_res["lse"], jax_res["grads"]
    q, k, v, g = (_to3d(x, tdt) for x in _inputs(d, *SHAPE, d))
    scale, bkv = d ** -0.5, tfa.kernel_block_kv(d, tdt)
    assert bkv == tfa.NARROW_BLOCK_KV[tfa.narrow_width(d)]
    o, lse = tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv)
    grads = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)
    jo = _to3d(j_out, torch.float32)
    assert o.dtype == tdt and all(x.dtype == tdt for x in grads)
    if dtype == "fp32":
        assert _rel_l2(o, jo) <= REL_L2
        assert np.abs(lse.numpy() - j_lse).max() <= LSE_ABS
        for name, mine, ref in zip(("dq", "dk", "dv"), grads, j_grads):
            assert _rel_l2(mine, _to3d(ref, torch.float32)) <= REL_L2, name
    else:
        ulp = float(jo.abs().max()) * 2.0 ** -7
        assert float((o.float() - jo).abs().max()) <= ulp
        assert np.abs(lse.numpy() - j_lse).max() <= BF16_LSE_ABS
        for name, mine, ref in zip(("dq", "dk", "dv"), grads, j_grads):
            assert (_rel_l2(mine, _to3d(ref, torch.float32))
                    <= BF16_GRAD_REL_L2), name


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", DIMS)
def test_plain_deferred_forward_matches_jax_pipelined_kernel(d, dtype):
    tdt = DTYPES[dtype][0]
    q, k, v = (torch.from_numpy(x[:, :, 0]).to(tdt)
               for x in _inputs(d + 1, *DEFERRED, 1, d)[:3])
    scale = d ** -0.5
    assert tfa._pipelined_takes(256, d) and not tfa._pipelined_takes(300, d)
    jo, jlse = _jax_results(d, dtype)["deferred"]
    o, lse = tfa.flash_fwd_pipelined_reference(q, k, v, scale,
                                               tfa.kernel_block_kv(d, tdt))
    if dtype == "fp32":
        # q prescaled by scale * log2 e, base 2, as JAX's deferred kernel
        assert _rel_l2(o, jo) <= REL_L2
        assert np.abs(lse.numpy() - jlse).max() <= LSE_ABS
    else:
        assert float(np.abs(o.float().numpy() - jo).max()) <= (
            float(np.abs(jo).max()) * 2.0 ** -7)
        assert np.abs(lse.numpy() - jlse).max() <= BF16_LSE_ABS


# the card's criteria (chip_smoke.py phase 3i): bf16 forwards at 3
# half-ulps of max |ref| and relative L2 2e-3 with the LSE within 1e-4,
# fp32 the precision contract
def _held(fp32, o, ro, lse, rlse) -> bool:
    if fp32:
        return (_rel_l2(o, ro) <= REL_L2
                and (lse - rlse).abs().max().item() <= LSE_ABS)
    diff = (o.float() - ro.float()).abs().max().item()
    return (diff <= 3 * ro.float().abs().max().item() * 2.0 ** -8
            and _rel_l2(o, ro) <= 2e-3
            and (lse - rlse).abs().max().item() <= 1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", (8, 40, 80))
def test_mutants_fail_the_card_criteria(d, dtype):
    tdt = DTYPES[dtype][0]
    fp32 = dtype == "fp32"
    q, k, v, _ = (_to3d(x, tdt) for x in _inputs(3, 1, 100, 300, 1, d))
    w, scale, bkv = tfa.narrow_width(d), d ** -0.5, tfa.kernel_block_kv(d, tdt)
    o, lse = tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv)
    assert _held(fp32, o, o, lse, lse)
    # the scale of the tile width
    mo, mlse = tfa.flash_fwd_tiled_reference(q, k, v, w ** -0.5, bkv)
    assert not _held(fp32, mo, o, mlse, lse)
    # the pad columns filled with 1.0: each score moves by (w - d) * scale,
    # so o keeps its value and the LSE does not
    pad = [torch.cat([x, torch.ones(x.shape[:-1] + (w - d,), dtype=tdt)], -1)
           for x in (q, k, v)]
    mo, mlse = tfa.flash_fwd_tiled_reference(*pad, scale, bkv)
    assert not _held(fp32, mo[..., :d], o, mlse, lse)
    # the last kv tile dropped
    mo, mlse = tfa.flash_fwd_tiled_reference(q, k[:, :-bkv], v[:, :-bkv],
                                             scale, bkv)
    assert not _held(fp32, mo, o, mlse, lse)
    if fp32:  # every product's operands rounded to TF32
        mo, mlse = tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv,
                                                 tf32=True)
        assert not _held(fp32, mo, o, mlse, lse)


NARROW_DIMS = [d for d in range(8, 129, 8) if d != 64]


def test_the_head_dim_rule():
    assert [d for d in range(1, 1100) if tfa.kernel_takes(d)] == sorted(
        NARROW_DIMS + [64, 256, 512])
    assert {d: tfa.narrow_width(d) for d in (8, 16, 24, 32, 40, 56, 72,
                                             128)} == {
        8: 16, 16: 16, 24: 32, 32: 32, 40: 64, 56: 64, 72: 128, 128: 128}
    assert [tfa.narrow_width(d) for d in (64, 256, 512, 73, 136)] == [None] * 5
    # the deferred kernel's rule counts in 64 at every narrow width, which
    # every narrow tile divides
    assert all(tfa.pipelined_block_kv(d) == 64
               and 64 % tfa.kernel_block_kv(d, dt) == 0
               for d in NARROW_DIMS for dt in tfa.KERNEL_DTYPES)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", NARROW_DIMS)
def test_wrappers_take_every_narrow_head_dim(d, dtype):
    tdt = DTYPES[dtype][0]
    q, k, v, o, do = (torch.empty((2, n, 2, d), device="meta", dtype=tdt)
                      for n in (128, 256, 256, 128, 128))
    lse = torch.empty((4, 128), device="meta")
    # a narrow head_dim passes every check but the device's
    for call in (lambda: tfa.flash_fwd(q, k, v, d ** -0.5),
                 lambda: tfa.flash_bwd_dq(q, k, v, o, lse, do, d ** -0.5),
                 lambda: tfa.flash_bwd_dkv(q, k, v, do, lse, lse, d ** -0.5)):
        with pytest.raises(ValueError, match="runs on cuda or cpu, not meta"):
            call()


@pytest.mark.parametrize("d", (73, 136, 384, 1024))
def test_other_head_dims_still_raise_naming_the_rule(d):
    for dtype in tfa.KERNEL_DTYPES:
        q, k, v, o, do = (torch.empty((1, n, 1, d), device="meta",
                                      dtype=dtype)
                          for n in (128, 256, 256, 128, 128))
        lse = torch.empty((1, 128), device="meta")
        for call in (lambda: tfa.flash_fwd(q, k, v, d ** -0.5),
                     lambda: tfa.flash_bwd_dq(q, k, v, o, lse, do, d ** -0.5),
                     lambda: tfa.flash_bwd_dkv(q, k, v, do, lse, lse,
                                               d ** -0.5)):
            with pytest.raises(ValueError,
                               match="64, 256, 512 or a multiple of 8 up to "
                                     "128"):
                call()


# the source of the two bf16 forwards at width 16; flash_narrow.cu keeps
# every other narrow entry
W16_SOURCE = "flash_narrow_w16_sm90.cu"


def _csrc(name):
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


def _narrow_defines() -> set:
    """The entries flash_narrow.cu's macro lines define: FLASH_NARROW_ENTRIES
    all four kinds, FLASH_NARROW_FWD_ENTRIES the forwards,
    FLASH_NARROW_BWD_ENTRIES the backward pair."""
    kinds = {"": KINDS, "FWD_": KINDS[:2], "BWD_": KINDS[2:]}
    return {f"flash_{kind}_{w}_{t}"
            for part, w, t in re.findall(
                r"^FLASH_NARROW_(FWD_|BWD_|)ENTRIES\(\w+, (w\d+), (\w+)\)$",
                _csrc("flash_narrow.cu"), re.M)
            for kind in kinds[part]}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("w", tfa.NARROW_WIDTHS)
def test_entry_names_and_counters(w, dtype):
    tdt = DTYPES[dtype][0]
    d = w - 8  # a head_dim of each width (8, 24, 56, 120)
    assert tfa.narrow_width(d) == w
    pre = ("fp32_" if dtype == "fp32" else "") + f"w{w}_"
    assert [tfa.kernel_name(kind, d, tdt) for kind in KINDS] == [
        f"flash_{kind}_w{w}_{dtype}" for kind in KINDS]
    assert [tfa.counter_name(kind, d, tdt) for kind in KINDS] == [
        f"{pre}launches", f"{pre}pipelined_launches",
        f"{pre}bwd_dq_launches", f"{pre}bwd_dkv_launches"]
    # every head_dim of a width shares its entries
    assert {tfa.kernel_name("fwd", e, tdt) for e in NARROW_DIMS
            if tfa.narrow_width(e) == w} == {f"flash_fwd_w{w}_{dtype}"}
    signatures = _build._signatures()
    every = tfa.counter_names()
    assert len(set(every)) == len(every) == 4 * 7 * 2
    for kind in KINDS:
        assert tfa.kernel_name(kind, d, tdt) in signatures
        # the head_dim after T: one more int than the other entries
        assert (len(signatures[tfa.kernel_name(kind, d, tdt)])
                == len(signatures[tfa.kernel_name(kind, 64, tdt)]) + 1)
        assert getattr(tfa.flash_attention, tfa.counter_name(kind, d, tdt)) \
            is not None
    # a forward counts in its own counter only, and its FLOPs at the real
    # head_dim
    q, k = (torch.empty((1, n, 2, d), device="meta", dtype=tdt)
            for n in (64, 4096))
    for pipelined in (False, True):
        before = {n: getattr(tfa.flash_attention, n) for n in every}
        flops = tfa.flash_attention.flops
        tfa._count_forward(q, k, pipelined)
        counter = tfa.counter_name("fwd_pipelined" if pipelined else "fwd", d,
                                   tdt)
        assert {n: getattr(tfa.flash_attention, n) - before[n]
                for n in every} == {n: int(n == counter) for n in every}
        assert tfa.flash_attention.flops - flops == 4 * 2 * 64 * 4096 * d
    # each entry is defined by one source that _build compiles: all four
    # bf16 kernels at width 16 by flash_narrow_w16_sm90.cu, every other one
    # by flash_narrow.cu
    narrow = _narrow_defines()
    w16 = set(re.findall(r'^extern "C" int (flash_\w*_w16_bf16)\(',
                         _csrc(W16_SOURCE), re.M))
    assert w16 == {f"flash_{kind}_w16_bf16" for kind in KINDS}
    assert {os.path.join(_build.CSRC, n) for n in (W16_SOURCE,
                                                   "flash_narrow.cu")} <= set(
        _build.sources())
    for kind in KINDS:
        entry = tfa.kernel_name(kind, d, tdt)
        moved = w == 16 and dtype == "bf16"
        assert (entry in w16, entry in narrow) == (moved, not moved), entry


def test_the_w16_forward_source_walks_the_tiles_the_wrappers_count_in():
    # the tiled plain versions, phase 3i and the dispatch rule count both
    # bf16 forwards at width 16 in kernel_block_kv(d, bf16, kind) =
    # NARROW_BLOCK_KV[16] and chip_smoke's waves in NARROW_W16_FWD_ROWS;
    # csrc/flash_narrow_w16_sm90.cu fixes the kv tile (kBlockKV) and the
    # query rows a block (kRows = 16 kWarps) at build time, and launches
    # ceil(S / kRows) blocks a (batch, head)
    text = _csrc(W16_SOURCE)
    assert re.findall(r"constexpr int kBlockKV = (\d+);", text) == [
        str(tfa.NARROW_BLOCK_KV[16])]
    warps = re.findall(r"constexpr int kWarps = (\d+),", text)
    assert [16 * int(x) for x in warps] == [tfa.NARROW_W16_FWD_ROWS]
    assert "constexpr int kRows = 16 * kWarps;" in text
    assert "dim3 grid((p.s_len + kRows - 1) / kRows, bh);" in text
    for d in (8, 16):
        assert tfa.narrow_width(d) == 16
        assert [tfa.kernel_block_kv(d, torch.bfloat16, kind)
                for kind in KINDS] == [tfa.NARROW_BLOCK_KV[16]] * 4
        # the deferred forward's rule counts whole tiles of the kernel's
        assert tfa.pipelined_block_kv(d) % tfa.NARROW_BLOCK_KV[16] == 0
    # every exponential of the two forwards is one MUFU instruction: no
    # exp2f / expf (whose lowering without -ftz keeps subnormal results)
    assert "ex2.approx.ftz.f32" in text
    code = re.sub(r"//[^\n]*", "", text)
    assert not re.search(r"\b(exp2f|expf|__expf|exp2)\(", code)
    # the D = 16 forwards take their launch bounds from their own constants
    assert re.findall(r"kMinBlocks16 = (\d+),\s+kMinBlocks16Deferred = (\d+);",
                      text)
    assert "kDeferred ? kMinBlocks16Deferred" in text


def _pair_code() -> str:
    """The backward pair's part of the width-16 source, comments left out:
    from the dq kernel's section to the launchers."""
    text = _csrc(W16_SOURCE)
    start = text.index("// dq and delta\n")
    end = text.index("template <int kD, bool kDeferred>\nint launch(")
    return re.sub(r"//[^\n]*", "", text[start:end])


def test_the_w16_pair_source_walks_the_tiles_the_wrappers_count_in():
    # the tiled plain version, phase 3i and the CPU tests hold the bf16 pair
    # at width 16 at kernel_block_kv(d, bf16, "bwd_dq" / "bwd_dkv") =
    # NARROW_BLOCK_KV[16], and chip_smoke's waves count its blocks in
    # NARROW_W16_BWD_ROWS; csrc/flash_narrow_w16_sm90.cu walks kBlockKV-row
    # tiles (kv tiles in dq, q tiles in dk/dv) with kBwdRows = 32 kWarps rows
    # a block (32 a warp), and launches ceil(S / kBwdRows) dq blocks and
    # ceil(T / kBwdRows) dk/dv blocks a (batch, head)
    text = _csrc(W16_SOURCE)
    code = _pair_code()
    assert re.findall(r"constexpr int kBlockKV = (\d+);", text) == [
        str(tfa.NARROW_BLOCK_KV[16])]
    warps = re.findall(r"constexpr int kWarps = (\d+),", text)
    assert "constexpr int kRows = 16 * kWarps;" in text
    assert "constexpr int kBwdRows = 2 * kRows;" in text
    assert [32 * int(x) for x in warps] == [tfa.NARROW_W16_BWD_ROWS]
    for d in (8, 16):
        assert [tfa.kernel_block_kv(d, torch.bfloat16, kind)
                for kind in ("bwd_dq", "bwd_dkv")] == [
            tfa.NARROW_BLOCK_KV[16]] * 2
    assert "dim3 grid((rows + kBwdRows - 1) / kBwdRows, b * h);" in text
    # dq's blocks over S with K and V streamed, dk/dv's over T with q and dO
    assert re.search(r"return backward\(d == 8 \? dq_kernel<8> : "
                     r"dq_kernel<16>, p, k, 1, v, 2,\s+s_len, b, h,", text)
    assert re.search(r"return backward\(d == 8 \? dkv_kernel<8> : "
                     r"dkv_kernel<16>, p, q, 0, dout, 3,\s+t_len, b, h,", text)
    assert re.search(r"int backward\(BwdKernel kernel, BwdParams p, "
                     r"const void\* x0, int s0,\s+const void\* x1, int s1, "
                     r"int rows,", text)
    # dq walks the kv axis and dk/dv the q axis in kBlockKV-row tiles
    assert "(t_len + kBlockKV - 1) / kBlockKV" in code
    assert "(s_len + kBlockKV - 1) / kBlockKV" in code
    # every exponential of the pair is one MUFU instruction (the forwards'
    # ex2): no exp2f / expf, and the LSE is never scaled a score
    assert code.count("ex2(fmaf(") == 8
    assert not re.search(r"\b(exp2f|expf|__expf|exp2)\(", code)
    # launch bounds of their own, by kernel and head_dim
    assert re.findall(r"constexpr int kDqMinBlocks8 = \d+, kDqMinBlocks16 = "
                      r"\d+, kDkvMinBlocks8 = \d+,\s+kDkvMinBlocks16 = \d+;",
                      text)
    assert "kD == 8 ? kDqMinBlocks8 : kDqMinBlocks16" in code
    assert "kD == 8 ? kDkvMinBlocks8 : kDkvMinBlocks16" in code


def test_the_bf16_mma_sync_pieces_live_in_one_header():
    # the ldmatrix loads, the bf16 mma.sync products and pack_bf16 are
    # csrc/bf16_mma_sync.cuh's; the mma.sync flash sources include it and
    # the wgmma kernels take pack_bf16 through flash_sm90.cuh, and none of
    # them defines one
    header = _csrc("bf16_mma_sync.cuh")
    pieces = ("void ldmatrix_x2(", "void ldmatrix_x2_trans(",
              "void ldmatrix_x4(", "void ldmatrix_x4_trans(", "void mma_bf16(",
              "void mma_bf16_k8(", "uint32_t pack_bf16(")
    for piece in pieces:
        assert piece in header, piece
    for source in ("flash_narrow.cu", W16_SOURCE, "flash_wide.cu",
                   "flash_sm90.cuh"):
        text = _csrc(source)
        assert '#include "bf16_mma_sync.cuh"' in text, source
        code = re.sub(r"//[^\n]*", "", text)
        for piece in pieces + ("ldmatrix.sync", "mma.sync"):
            assert piece not in code, (source, piece)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")


def _card_held(fp32, got, ref, fwd=True) -> bool:
    """chip_smoke.py phase 3i's criteria: fp32 relative L2 1e-5; bf16 3
    half-ulps of max |ref| and relative L2 2e-3 (forward) or 1e-3."""
    if fp32:
        return _rel_l2(got.cpu(), ref.cpu()) <= REL_L2
    diff = (got.float() - ref.float()).abs().max().item()
    return (diff <= 3 * ref.float().abs().max().item() * 2.0 ** -8
            and _rel_l2(got.float().cpu(), ref.float().cpu())
            <= (2e-3 if fwd else 1e-3))


CUDA_DIMS = (8, 16, 32, 40, 80, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", CUDA_DIMS)
def test_cuda_narrow_kernels_match_plain(d, dtype):
    _skip_without_card()
    tdt = DTYPES[dtype][0]
    fp32 = dtype == "fp32"
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(d)
    scale, bkv = d ** -0.5, tfa.kernel_block_kv(d, tdt)
    counters = [tfa.counter_name(kind, d, tdt) for kind in KINDS]
    # ragged T; whole tiles; ragged S with T whole tiles (both forwards,
    # the deferred one on the standard one's bits); one partial block, T
    # below one kv tile, lengths that are no multiple of 4
    for bh, s, t in ((2, 1000, 1500), (3, 2048, 2048), (2, 1000, 1536),
                     (3, 37, 45), (1, 129, 65), (2, 1001, 203)):
        q, k, v, g = (torch.randn((bh, n, d), generator=gen, device="cuda",
                                  dtype=tdt) for n in (s, t, t, s))
        before = [getattr(tfa.flash_attention, n) for n in counters]
        o, lse = tfa.flash_fwd_3d(q, k, v, scale)
        dq, delta = tfa.flash_bwd_dq_3d(q, k, v, o, lse, g, scale)
        dk, dv = tfa.flash_bwd_dkv_3d(q, k, v, g, lse, delta, scale)
        again = (*tfa.flash_fwd_3d(q, k, v, scale),
                 *tfa.flash_bwd_dq_3d(q, k, v, o, lse, g, scale),
                 *tfa.flash_bwd_dkv_3d(q, k, v, g, lse, delta, scale))
        torch.cuda.synchronize()
        assert [getattr(tfa.flash_attention, n) - b
                for n, b in zip(counters, before)] == [2, 0, 2, 2]
        assert all(torch.equal(a, b)
                   for a, b in zip((o, lse, dq, delta, dk, dv), again))
        ro, rlse = tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv)
        assert _card_held(fp32, o, ro)
        assert (lse - rlse).abs().max().item() <= (LSE_ABS if fp32 else 1e-4)
        assert (delta - tfa._delta(o, g)).abs().max().item() <= 1e-5
        ref = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)
        for name, mine, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            assert _card_held(fp32, mine, r, fwd=False), name
        if tfa._pipelined_takes(t, d):
            po, plse = tfa.flash_fwd_3d_pipelined(q, k, v, scale)
            po2, _ = tfa.flash_fwd_3d_pipelined(q, k, v, scale)
            torch.cuda.synchronize()
            pref, plref = tfa.flash_fwd_pipelined_reference(q, k, v, scale,
                                                            bkv)
            assert torch.equal(po, po2) and _card_held(fp32, po, pref)
            assert (plse - plref).abs().max().item() <= (
                LSE_ABS if fp32 else 1e-4)
            if not fp32:  # the same arithmetic in another order
                assert torch.equal(po, o) and torch.equal(plse, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", (8, 16, 40))
def test_cuda_strided_views_give_the_contiguous_bits(d, dtype):
    _skip_without_card()
    tdt = DTYPES[dtype][0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, 1024, 4, 2, d), generator=gen, device="cuda",
                    dtype=tdt)
    q, k, v, g = (x[:, :, i] for i in range(4))
    scale = d ** -0.5
    o, lse = tfa.flash_fwd(q, k, v, scale)
    grads = tfa.flash_bwd(q, k, v, o, lse, g, scale)
    flat = [y.contiguous() for y in (q, k, v, g)]
    o2, lse2 = tfa.flash_fwd(*flat[:3], scale)
    grads2 = tfa.flash_bwd(*flat[:3], o2, lse2, flat[3], scale)
    torch.cuda.synchronize()
    assert o.is_contiguous() and torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(a.is_contiguous() and torch.equal(a, b)
               for a, b in zip(grads, grads2))


@pytest.mark.cuda
def test_cuda_other_head_dims_raise_and_launch_nothing():
    _skip_without_card()
    every = tfa.counter_names()
    before = [getattr(tfa.flash_attention, n) for n in every]
    for d in (73, 136, 384):
        q = torch.zeros((1, 1024, 1, d), device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="multiple of 8 up to 128"):
            tfa.flash_attention(q, q, q)
    assert before == [getattr(tfa.flash_attention, n) for n in every]
