"""PyTorch port, flash attention on fp32 inputs (``csrc/flash_fp32.cu``'s
forwards at head_dim 64 and the backward pair
``csrc/flash_fp32_d64_bwd_sm90.cu``; at head_dims 256 and 512 the forwards
``csrc/flash_fp32_d{256,512}_sm90.cu`` and the backward pairs
``csrc/flash_fp32_d{256,512}_bwd_sm90.cu``):
the plain fp32 versions of the forward, the deferred-softmax forward and
the backward on the CPU against the JAX package's fp32 flash attention
(Pallas kernels in interpret mode, as tests/test_flash_attention.py runs
them) at head_dims 64, 256 and 512 with a ragged T, the tiled plain
forwards and backward at the 256 and 512 kernels' own tile and the
backward at the 64 pair's; the kv tile of each kind, the 512, 256 and 64
sources' constants, the tf32 wgmma header they share with the int8
matmul, the cluster header of the 512 and 256 sources and the score
header of both 256 sources; the TF32 mutant and the other mutants
that the card's bound must refuse; the wrappers' dtype and layout checks,
entry names and counters; the device numerics rule.

The precision contract (the head of ``csrc/flash_fp32.cu``): o, dq, dk and
dv within relative L2 1e-5, the LSE within 1e-5 absolute.  The CUDA
kernels run only on a card: their tests are marked ``cuda`` and skip
elsewhere.  This file imports only ``diffute_tpu.ops`` of the JAX package,
so the card's image (jax without flax) runs its ``cuda`` tests.
"""

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

from diffute_tpu_torch.config import UNetConfig, VAEConfig
from diffute_tpu_torch.ops import _build
from diffute_tpu_torch.utils.device import configure_cuda_numerics
from port_threads import torch_threads_per_worker  # noqa: F401

tfa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")

WIDTHS = (64, 256, 512)
# the precision contract: fp32 on both sides, the sums in other orders
REL_L2, LSE_ABS = 1e-5, 1e-5
KINDS = ("fwd", "fwd_pipelined", "bwd_dq", "bwd_dkv")


def _rel_l2(got, ref) -> float:
    got, ref = (torch.as_tensor(np.array(x)).float() for x in (got, ref))
    return ((got - ref).norm() / ref.norm()).item()


def _inputs(seed, b, s, t, h, d):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d),
                               (b, s, h, d)))


def _jax_fwd_and_grads(q, k, v, g):
    """The JAX fp32 flash forward's o and LSE (natural log, (BH, S)) and
    jax.grad of sum(flash_attention(q, k, v) * g), (B, L, H, D) arrays."""
    q, k, v, g = (jnp.asarray(x) for x in (q, k, v, g))
    out, (_, _, _, _, lse) = jfa._flash_fwd_rule(q, k, v, None, None, None)
    grads = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v) * g),
                     argnums=(0, 1, 2))(q, k, v)
    return (np.asarray(out), np.asarray(lse)[..., 0],
            [np.asarray(x) for x in grads])


def _to3d(x):
    return tfa._to3d(torch.from_numpy(np.array(x)))


# (B, S, T, H): S and T ragged against every width's tile (64, 32, 16)
SHAPE = (1, 100, 300, 1)


@pytest.mark.parametrize("d", WIDTHS)
def test_plain_fp32_versions_match_jax_and_the_tf32_mutant_does_not(d):
    q, k, v, g = _inputs(d, *SHAPE, d)
    j_out, j_lse, j_grads = _jax_fwd_and_grads(q, k, v, g)
    scale, bkv = d ** -0.5, tfa.FP32_BLOCK_KV[d]
    q3, k3, v3, g3 = (_to3d(x) for x in (q, k, v, g))
    jo3 = _to3d(j_out)

    # the standard forward: the natural domain, the fp32 default
    o, lse = tfa.flash_fwd_tiled_reference(q3, k3, v3, scale, bkv)
    assert o.dtype == lse.dtype == torch.float32
    assert torch.equal(o, tfa.flash_fwd_tiled_reference(
        q3, k3, v3, scale, bkv, "natural")[0])
    assert _rel_l2(o, jo3) <= REL_L2
    assert np.abs(lse.numpy() - j_lse).max() <= LSE_ABS
    # the wrapper's CPU route (the one-pass plain version) agrees too
    wo, wlse = tfa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    assert _rel_l2(wo, j_out) <= REL_L2
    assert np.abs(wlse.numpy() - j_lse).max() <= LSE_ABS

    # the backward: p = exp(s * scale - lse), fp32 p and ds
    grads = tfa.flash_bwd_tiled_reference(q3, k3, v3, o, lse, g3, scale, bkv)
    for name, mine, ref in zip(("dq", "dk", "dv"), grads, j_grads):
        assert _rel_l2(mine, _to3d(ref)) <= REL_L2, name

    # every product's operands rounded to TF32: about 1e-3, refused
    mo, _ = tfa.flash_fwd_tiled_reference(q3, k3, v3, scale, bkv, tf32=True)
    assert _rel_l2(mo, jo3) > 10 * REL_L2
    mgrads = tfa.flash_bwd_tiled_reference(q3, k3, v3, o, lse, g3, scale, bkv,
                                           tf32=True)
    for name, mine, ref in zip(("dq", "dk", "dv"), mgrads, j_grads):
        assert _rel_l2(mine, _to3d(ref)) > 10 * REL_L2, name


def test_the_fp32_kernels_tile_by_kind_at_512():
    # all four fp32 kernels at 512 (both forwards in
    # csrc/flash_fp32_d512_sm90.cu, the backward pair in
    # csrc/flash_fp32_d512_bwd_sm90.cu) walk one 32-row tile, so the call
    # without a kind names it
    fp32 = torch.float32
    assert [tfa.kernel_block_kv(512, fp32, kind) for kind in KINDS] == [
        tfa.FP32_BLOCK_KV[512]] * 4 == [32] * 4
    assert tfa.kernel_block_kv(512, fp32) == 32
    # one tile for all four at 256; at 64 the forwards walk
    # FP32_BLOCK_KV[64] and the backward pair (csrc/flash_fp32_d64_bwd_sm90.cu)
    # FP32_D64_BWD_BLOCK_KV, so the call without a kind refuses; the bf16
    # ones at 512 keep theirs
    assert tfa.kernel_block_kv(256, fp32) == 32
    assert [tfa.kernel_block_kv(64, fp32, kind) for kind in KINDS] == [
        64, 64, 32, 32] == [tfa.FP32_BLOCK_KV[64]] * 2 + [
            tfa.FP32_D64_BWD_BLOCK_KV] * 2
    with pytest.raises(ValueError, match="name the kind"):
        tfa.kernel_block_kv(64, fp32)
    assert tfa.kernel_block_kv(512, torch.bfloat16) == tfa.WIDE_BLOCK_KV
    # the deferred forward's dispatch rule counts in a whole number of the
    # fp32 forward's tiles
    assert tfa.pipelined_block_kv(512) % tfa.kernel_block_kv(
        512, fp32, "fwd_pipelined") == 0


def test_the_d512_fp32_backward_source_walks_the_tile_the_wrappers_count_in():
    # the tiled plain versions and phase 3f count in FP32_BLOCK_KV[512] and
    # FP32_D512_ROWS; csrc/flash_fp32_d512_sm90.cuh fixes the streamed tile
    # and a cluster's resident rows at build time for both 512 sources (the
    # forwards' csrc/flash_fp32_d512_sm90.cu, the backward pair's
    # csrc/flash_fp32_d512_bwd_sm90.cu), which define neither themselves;
    # csrc/flash_fp32.cu instantiates nothing at 512
    csrc = os.path.join(os.path.dirname(tfa.__file__), os.pardir, "csrc")

    def read(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()

    header = read("flash_fp32_d512_sm90.cuh")
    for name, value in (("kBlockKV", tfa.FP32_BLOCK_KV[512]),
                        ("kRows", tfa.FP32_D512_ROWS)):
        assert re.findall(rf"constexpr int {name} = (\d+);", header) == [
            str(value)], name
    for source, entries in (
            ("flash_fp32_d512_bwd_sm90.cu", ("flash_bwd_dq_d512_fp32",
                                             "flash_bwd_dkv_d512_fp32")),
            ("flash_fp32_d512_sm90.cu", ("flash_fwd_d512_fp32",
                                         "flash_fwd_pipelined_d512_fp32"))):
        text = read(source)
        assert '#include "flash_fp32_d512_sm90.cuh"' in text, source
        for name in ("kBlockKV", "kRows"):
            assert f"constexpr int {name} =" not in text, (source, name)
        for entry in entries:
            assert f'extern "C" int {entry}(' in text, entry
    fp32 = read("flash_fp32.cu")
    assert "F512" not in fp32 and "Fp32<512" not in fp32
    # flash_fp32.cu defines both forwards at 64 and nothing else: the
    # backward pair at 64 is csrc/flash_fp32_d64_bwd_sm90.cu's, all four at
    # 256 csrc/flash_fp32_d256_sm90.cu's and csrc/flash_fp32_d256_bwd_sm90.cu's
    assert re.findall(r'^extern "C" int (\w+)\(', fp32, re.M) == [
        "flash_fwd_fp32", "flash_fwd_pipelined_fp32"]
    assert re.findall(r"using (\w+) = Fp32<", fp32) == ["F64"]
    for name in ("dq_kernel", "dkv_kernel", "flash_bwd_", "Fp32<256"):
        assert name not in fp32, name


def _csrc(name):
    with open(os.path.join(os.path.dirname(tfa.__file__), os.pardir, "csrc",
                           name)) as f:
        return f.read()


def test_the_d64_fp32_backward_source_walks_the_tile_the_wrappers_count_in():
    # the tiled plain versions and phase 3f count the fp32 backward pair at
    # 64 in kernel_block_kv(64, fp32, "bwd_dq" / "bwd_dkv");
    # csrc/flash_fp32_d64_bwd_sm90.cu fixes its streamed tile (the kv tile
    # dq walks, the q tile dk/dv walks) and a consumer's resident rows at
    # build time, and defines the pair's two entries under the names the
    # wrappers launch
    fp32 = torch.float32
    text = _csrc("flash_fp32_d64_bwd_sm90.cu")
    assert re.findall(r"constexpr int kBlockKV = (\d+);", text) == [
        str(tfa.FP32_D64_BWD_BLOCK_KV)]
    assert [tfa.kernel_block_kv(64, fp32, kind)
            for kind in ("bwd_dq", "bwd_dkv")] == [tfa.FP32_D64_BWD_BLOCK_KV] * 2
    assert re.findall(r"constexpr int kRows = (\d+);", text) == ["64"]
    for kind in ("bwd_dq", "bwd_dkv"):
        entry = tfa.kernel_name(kind, 64, fp32)
        assert f'extern "C" int {entry}(' in text, entry
    # the forwards at 64 keep flash_fp32.cu's 64-row tile
    assert [tfa.kernel_block_kv(64, fp32, kind)
            for kind in ("fwd", "fwd_pipelined")] == [tfa.FP32_BLOCK_KV[64]] * 2


# both fp32 sources at head_dim 256 and what they define: the backward pair
# (csrc/flash_fp32_d256_bwd_sm90.cu) and the two forwards
# (csrc/flash_fp32_d256_sm90.cu)
D256_SOURCES = {"flash_fp32_d256_bwd_sm90.cu": ("bwd_dq", "bwd_dkv"),
                "flash_fp32_d256_sm90.cu": ("fwd", "fwd_pipelined")}


def _d256_layout_walks_the_tile_the_wrappers_count_in(source):
    # the tiled plain versions and phase 3f count all four fp32 kernels at
    # 256 in kernel_block_kv(256, fp32, kind) = FP32_BLOCK_KV[256] and
    # FP32_D256_ROWS, FP32_D256_RANKS; csrc/flash_fp32_d256_sm90.cuh fixes
    # the streamed tile (the kv tile of the forwards and dq, the q tile of
    # dk/dv), a cluster's resident rows and its blocks over head_dim at
    # build time for both sources, which define none of them themselves,
    # and each source defines its kernels' entries and the clusters query
    # under the names the wrappers launch
    fp32 = torch.float32
    header = _csrc("flash_fp32_d256_sm90.cuh")
    for name, value in (("kBlockKV", tfa.FP32_BLOCK_KV[256]),
                        ("kRows", tfa.FP32_D256_ROWS),
                        ("kRanks", tfa.FP32_D256_RANKS),
                        ("kD", 256)):
        assert re.findall(rf"constexpr int {name} = (\d+);", header) == [
            str(value)], name
    assert "constexpr int kCols = kD / kRanks;" in header
    text = _csrc(source)
    assert '#include "flash_fp32_d256_sm90.cuh"' in text
    for name in ("kBlockKV", "kRows", "kRanks", "kD", "kCols"):
        assert f"constexpr int {name} =" not in text, name
    kinds = D256_SOURCES[source]
    assert [tfa.kernel_block_kv(256, fp32, kind) for kind in kinds] == [
        tfa.FP32_BLOCK_KV[256]] * 2
    for kind in kinds:
        entry = tfa.kernel_name(kind, 256, fp32)
        assert f'extern "C" int {entry}(' in text, entry
        assert entry not in _csrc("flash_fp32.cu"), entry
    clusters = f"flash_{kinds[0][:3]}_d256_fp32_max_clusters"
    assert f'extern "C" int {clusters}(' in text
    assert clusters in _build._signatures()


def test_the_d256_fp32_backward_source_walks_the_tile_the_wrappers_count_in():
    _d256_layout_walks_the_tile_the_wrappers_count_in(
        "flash_fp32_d256_bwd_sm90.cu")


def test_the_d256_fp32_forward_source_walks_the_tile_the_wrappers_count_in():
    _d256_layout_walks_the_tile_the_wrappers_count_in(
        "flash_fp32_d256_sm90.cu")
    # one tile for all four kernels at 256, so the call without a kind
    # names it
    assert tfa.kernel_block_kv(256, torch.float32) == tfa.FP32_BLOCK_KV[256]


def test_the_tf32_wgmma_pieces_live_in_one_header():
    # the tf32 wgmma instructions and wrappers, the k-step descriptor, the
    # plane splits, the streamed tile's loads, reads and natural and
    # transposed writes, the split score fragments, the output product over
    # a 32-row tile and its store are csrc/tf32_wgmma_sm90.cuh's; the int8
    # matmul on fp32 x and the head_dim-64 and 256 fp32 backward pairs
    # include it and define none of them
    header = _csrc("tf32_wgmma_sm90.cuh")
    pieces = ("void wgmma_tf32(", "void wgmma_tf32_ss(",
              "uint64_t tf32_desc(", "void split4(",
              "#define TF32_WGMMA_N32 ", "#define TF32_WGMMA_N64 ",
              "void split_chunk(", "void split_plane(", "void split_frags(",
              "void issue_out(", "void release_warp(", "void add_part(",
              "#define TF32_RS_N64(", "void load_plane(", "struct StreamRaw",
              "void read_stream(", "void read_transposed(",
              "void write_natural(", "void write_transposed(",
              "void store_rows(", "((((d & 31) >> 2) ^ (r & 7)) << 4)")
    for piece in pieces:
        assert piece in header, piece
    # the 256 sources include it through their layout's header
    d256 = "flash_fp32_d256_sm90.cuh"
    assert '#include "tf32_wgmma_sm90.cuh"' in _csrc(d256)
    for source in ("quant_fp32_sm90.cu", "flash_fp32_d64_bwd_sm90.cu",
                   d256, *D256_SOURCES):
        text = _csrc(source)
        assert (f'#include "{d256}"' if source in D256_SOURCES
                else '#include "tf32_wgmma_sm90.cuh"') in text, source
        for piece in pieces + ("rna_tf32(", "wgmma.mma_async"):
            assert piece not in text, (source, piece)


def test_the_cluster_pieces_live_in_one_header():
    # the cluster's rank, mapa, remote stores, the split cluster barrier,
    # the asynchronous remote store, the cluster-scope wait and the cluster
    # launch are csrc/cluster_sm90.cuh's; the 512 and 256 layouts' headers
    # (and through them all four sources) include it and define none of
    # them
    header = _csrc("cluster_sm90.cuh")
    pieces = ("%%cluster_ctarank", "mapa.shared::cluster",
              "st.shared::cluster.v4", "barrier.cluster.arrive",
              "barrier.cluster.wait", "st.async.shared", "acquire.cluster",
              "cudaLaunchAttributeClusterDimension",
              "cudaOccupancyMaxActiveClusters(")
    for piece in pieces:
        assert piece in header, piece
    layouts = {"flash_fp32_d512_sm90.cuh": ("flash_fp32_d512_sm90.cu",
                                            "flash_fp32_d512_bwd_sm90.cu"),
               "flash_fp32_d256_sm90.cuh": tuple(D256_SOURCES)}
    for layout, sources in layouts.items():
        assert '#include "cluster_sm90.cuh"' in _csrc(layout), layout
        for source in (layout, *sources):
            text = _csrc(source)
            assert source == layout or f'#include "{layout}"' in text, source
            for piece in pieces:
                assert piece not in text, (source, piece)
    # the score products and the exchange of both 256 sources are their
    # layout header's, one piece of code: on the same Q and K the forwards'
    # S and the backward pair's are the same bits
    scores = ("void issue_scores(", "void send_part(", "float4 sum_ranks(",
              "void gathered_frags(", "struct Exchange {",
              "Exchange exchange(", "void scatter(", "struct Barriers {",
              "#define D256_SS(", "__fadd_rn(a[4 * n], b[4 * n])")
    d256 = _csrc("flash_fp32_d256_sm90.cuh")
    for piece in scores:
        assert piece in d256, piece
    for source in D256_SOURCES:
        text = _csrc(source)
        assert "issue_scores(" in text and "sum_ranks(" in text, source
        for piece in scores:
            assert piece not in text, (source, piece)


def test_the_fp32_tma_host_side_lives_in_one_header():
    # the map of an fp32 tensor in 32-column boxes and the backward pairs'
    # kernel parameter, filled from the C entries' arguments, are
    # csrc/fp32_tma_sm90.cuh's; the pairs at 64, 256 and 512 and the 512
    # forwards include it (the forwards through the 512 layout's header)
    # and encode no map themselves
    header = _csrc("fp32_tma_sm90.cuh")
    for piece in ("struct BwdParams {", "inline bool encode_fp32(",
                  "cudaError_t fill_params(", "CU_TENSOR_MAP_DATA_TYPE_FLOAT32"):
        assert piece in header, piece
    pairs = ("flash_fp32_d64_bwd_sm90.cu", "flash_fp32_d256_bwd_sm90.cu",
             "flash_fp32_d512_bwd_sm90.cu")
    for source in pairs + ("flash_fp32_d512_sm90.cu",
                           "flash_fp32_d512_sm90.cuh",
                           "flash_fp32_d256_sm90.cu",
                           "flash_fp32_d256_sm90.cuh"):
        text = _csrc(source)
        for piece in ("struct BwdParams {", "CU_TENSOR_MAP_DATA_TYPE_FLOAT32",
                      "encode_fn()"):
            assert piece not in text, (source, piece)
    for source in pairs:
        assert "fp32_tma::fill_params(" in _csrc(source), source
    for layout in ("flash_fp32_d512_sm90.cuh", "flash_fp32_d256_sm90.cuh"):
        assert '#include "fp32_tma_sm90.cuh"' in _csrc(layout), layout


@pytest.mark.parametrize("s,t", [(100, 300), (96, 160), (40, 72)])
def test_plain_fp32_backward_at_the_d64_bwd_tile_matches_jax(s, t):
    # the tiled plain backward at the 64 pair's own tile (32 rows) against
    # the JAX package's fp32 _flash_bwd_3d (Pallas in interpret mode) on
    # the same o and LSE, S and T ragged against the tile and whole, two
    # heads
    d = 64
    q, k, v, g = (_to3d(x) for x in _inputs(d + 4, 1, s, t, 2, d))
    scale = d ** -0.5
    bkv = tfa.kernel_block_kv(d, torch.float32, "bwd_dkv")
    assert bkv == tfa.kernel_block_kv(d, torch.float32, "bwd_dq") == 32
    jq, jk, jv, jg = (jnp.asarray(x.numpy()) for x in (q, k, v, g))
    jo, jlse = jfa._flash_fwd_3d(jq, jk, jv, scale, 128, 128)
    j_grads = jfa._flash_bwd_3d(jq, jk, jv, jo, jlse, jg, scale, 128, 128)
    o = torch.from_numpy(np.array(jo))
    lse = torch.from_numpy(np.array(jlse))[..., 0]
    grads = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)
    for name, mine, ref in zip(("dq", "dk", "dv"), grads, j_grads):
        assert _rel_l2(mine, ref) <= REL_L2, name
    # the kernels' mutants at this tile: TF32 operands, the last kv tile
    # dropped from dq, dk x (1 + 1e-4)
    mgrads = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv,
                                           tf32=True)
    for name, mine, ref in zip(("dq", "dk", "dv"), mgrads, j_grads):
        assert _rel_l2(mine, ref) > 10 * REL_L2, name
    cut = (t - 1) // bkv * bkv
    mdq = tfa.flash_bwd_tiled_reference(q, k[:, :cut], v[:, :cut], o, lse, g,
                                        scale, bkv)[0]
    assert _rel_l2(mdq, j_grads[0]) > REL_L2
    assert _rel_l2(grads[1] * (1 + 1e-4), j_grads[1]) > REL_L2


@pytest.mark.parametrize("s,t", [(100, 300), (96, 160)])
def test_plain_fp32_backward_at_the_d256_bwd_tile_matches_jax(s, t):
    # the tiled plain backward at the 256 pair's own tile (32 rows) against
    # the JAX package's fp32 _flash_bwd_3d (Pallas in interpret mode) on
    # the same o and LSE, S and T ragged against the tile (and a cluster's
    # 64 rows) and whole
    d = 256
    q, k, v, g = (_to3d(x) for x in _inputs(d + 5, 1, s, t, 1, d))
    scale = d ** -0.5
    bkv = tfa.kernel_block_kv(d, torch.float32, "bwd_dkv")
    assert bkv == tfa.kernel_block_kv(d, torch.float32, "bwd_dq") == 32
    jq, jk, jv, jg = (jnp.asarray(x.numpy()) for x in (q, k, v, g))
    jo, jlse = jfa._flash_fwd_3d(jq, jk, jv, scale, 128, 128)
    j_grads = jfa._flash_bwd_3d(jq, jk, jv, jo, jlse, jg, scale, 128, 128)
    o = torch.from_numpy(np.array(jo))
    lse = torch.from_numpy(np.array(jlse))[..., 0]
    grads = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)
    for name, mine, ref in zip(("dq", "dk", "dv"), grads, j_grads):
        assert _rel_l2(mine, ref) <= REL_L2, name
    # the kernels' mutants at this tile: TF32 operands, the last kv tile
    # dropped from dq, dk x (1 + 1e-4)
    mgrads = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv,
                                           tf32=True)
    for name, mine, ref in zip(("dq", "dk", "dv"), mgrads, j_grads):
        assert _rel_l2(mine, ref) > 10 * REL_L2, name
    cut = (t - 1) // bkv * bkv
    mdq = tfa.flash_bwd_tiled_reference(q, k[:, :cut], v[:, :cut], o, lse, g,
                                        scale, bkv)[0]
    assert _rel_l2(mdq, j_grads[0]) > REL_L2
    assert _rel_l2(grads[1] * (1 + 1e-4), j_grads[1]) > REL_L2


@pytest.mark.parametrize("s,t", [(100, 300), (96, 160)])
def test_plain_fp32_backward_at_the_d512_tile_matches_jax(s, t):
    # the tiled plain backward at the 512 pair's own tile (32 rows) against
    # the JAX package's fp32 _flash_bwd_3d (Pallas in interpret mode) on
    # the same o and LSE, T ragged against the tile and whole
    d = 512
    q, k, v, g = (_to3d(x) for x in _inputs(d + 2, 1, s, t, 1, d))
    scale = d ** -0.5
    bkv = tfa.kernel_block_kv(d, torch.float32, "bwd_dkv")
    assert bkv == tfa.kernel_block_kv(d, torch.float32, "bwd_dq") == 32
    jq, jk, jv, jg = (jnp.asarray(x.numpy()) for x in (q, k, v, g))
    jo, jlse = jfa._flash_fwd_3d(jq, jk, jv, scale, 128, 128)
    j_grads = jfa._flash_bwd_3d(jq, jk, jv, jo, jlse, jg, scale, 128, 128)
    o = torch.from_numpy(np.array(jo))
    lse = torch.from_numpy(np.array(jlse))[..., 0]
    grads = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)
    for name, mine, ref in zip(("dq", "dk", "dv"), grads, j_grads):
        assert _rel_l2(mine, ref) <= REL_L2, name
    # the kernels' mutants at this tile: TF32 operands, the last kv tile
    # dropped from dq, dk x (1 + 1e-4)
    mgrads = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv,
                                           tf32=True)
    for name, mine, ref in zip(("dq", "dk", "dv"), mgrads, j_grads):
        assert _rel_l2(mine, ref) > 10 * REL_L2, name
    cut = (t - 1) // bkv * bkv
    mdq = tfa.flash_bwd_tiled_reference(q, k[:, :cut], v[:, :cut], o, lse, g,
                                        scale, bkv)[0]
    assert _rel_l2(mdq, j_grads[0]) > REL_L2
    assert _rel_l2(grads[1] * (1 + 1e-4), j_grads[1]) > REL_L2


@pytest.mark.parametrize("d,pipelined,s,t", [
    pytest.param(512, False, 100, 300, id="False-100-300"),
    pytest.param(512, True, 64, 96, id="True-64-96"),
    pytest.param(256, False, 100, 300, id="d256-False-100-300"),
    pytest.param(256, True, 64, 96, id="d256-True-64-96")])
def test_plain_fp32_forwards_at_the_d512_tile_match_jax(d, pipelined, s, t):
    # the tiled plain forward at both forwards' own tile (32 rows) at 512
    # and at 256 (the cluster layouts' tile), in each one's domain, against
    # the JAX package's fp32 _flash_fwd_3d (ragged S and T) and
    # _flash_fwd_3d_pipelined (T three whole tiles), Pallas in interpret
    # mode
    q, k, v, _ = (_to3d(x) for x in _inputs(d + 3, 1, s, t, 1, d))
    scale = d ** -0.5
    kind = "fwd_pipelined" if pipelined else "fwd"
    bkv = tfa.kernel_block_kv(d, torch.float32, kind)
    assert bkv == 32
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    if pipelined:
        with pltpu.force_tpu_interpret_mode():
            jo, jlse = jfa._flash_fwd_3d_pipelined(jq, jk, jv, scale, s, bkv)
        domain = "prescaled"
    else:
        jo, jlse = jfa._flash_fwd_3d(jq, jk, jv, scale, 128, 128)
        domain = "natural"
    jlse = np.asarray(jlse)[..., 0]
    o, lse = tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv, domain)
    assert _rel_l2(o, jo) <= REL_L2
    assert np.abs(lse.numpy() - jlse).max() <= LSE_ABS
    # the mutants the card's bound must refuse: TF32 operands, the last kv
    # tile dropped
    mo, _ = tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv, domain,
                                          tf32=True)
    assert _rel_l2(mo, jo) > 10 * REL_L2
    cut = (t - 1) // bkv * bkv
    mo, mlse = tfa.flash_fwd_tiled_reference(q, k[:, :cut], v[:, :cut],
                                             scale, bkv, domain)
    assert _rel_l2(mo, jo) > REL_L2
    assert np.abs(mlse.numpy() - jlse).max() > LSE_ABS


@pytest.mark.parametrize("d", WIDTHS)
def test_plain_fp32_deferred_forward_matches_jax_pipelined_kernel(d):
    q, k, v, _ = (_to3d(x) for x in _inputs(d + 1, 1, 128, 256, 1, d))
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jfa._flash_fwd_3d_pipelined(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)), scale, 128, 128)
    jlse = np.asarray(jlse)[..., 0]
    o, lse = tfa.flash_fwd_pipelined_reference(q, k, v, scale,
                                               tfa.FP32_BLOCK_KV[d])
    # fp32: q prescaled by scale * log2 e, base 2, as JAX's deferred kernel
    assert torch.equal(o, tfa.flash_fwd_tiled_reference(
        q, k, v, scale, tfa.FP32_BLOCK_KV[d], "prescaled")[0])
    assert _rel_l2(o, jo) <= REL_L2
    assert np.abs(lse.numpy() - jlse).max() <= LSE_ABS
    # the natural domain on prescaled q (exp of base-2 scores) is refused
    bad = tfa.flash_fwd_tiled_reference(
        (q * (scale * tfa._LOG2E)), k, v, 1.0, tfa.FP32_BLOCK_KV[d],
        "natural")
    assert (_rel_l2(bad[0], jo) > 10 * REL_L2
            or np.abs(bad[1].numpy() - jlse).max() > LSE_ABS)
    mo, _ = tfa.flash_fwd_pipelined_reference(q, k, v, scale,
                                              tfa.FP32_BLOCK_KV[d], tf32=True)
    assert _rel_l2(mo, jo) > 10 * REL_L2


@pytest.mark.parametrize("d", WIDTHS)
def test_the_other_mutants_fail_the_bound(d):
    q, k, v, g = (_to3d(x) for x in _inputs(7, 1, 64, 160, 1, d))
    scale, bkv = d ** -0.5, tfa.FP32_BLOCK_KV[d]
    o, lse = tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv)
    # the LSE left in base 2
    assert (lse / tfa._LN2 - lse).abs().max().item() > LSE_ABS
    # the last kv tile never consumed
    cut = k.shape[1] - bkv
    mo, mlse = tfa.flash_fwd_tiled_reference(q, k[:, :cut], v[:, :cut],
                                             scale, bkv)
    assert _rel_l2(mo, o) > REL_L2 and (mlse - lse).abs().max() > LSE_ABS
    # dk x (1 + 1e-4)
    dk = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bkv)[1]
    assert _rel_l2(dk * (1 + 1e-4), dk) > REL_L2


@pytest.mark.parametrize("d", WIDTHS)
def test_wrappers_take_fp32_at_every_width(d):
    q, k, v, o, do = (torch.empty((2, n, 3, d), device="meta")
                      for n in (128, 256, 256, 128, 128))
    lse = torch.empty((6, 128), device="meta")
    # fp32 passes every check but the device's
    for call in (lambda: tfa.flash_fwd(q, k, v, d ** -0.5),
                 lambda: tfa.flash_bwd_dq(q, k, v, o, lse, do, d ** -0.5),
                 lambda: tfa.flash_bwd_dkv(q, k, v, do, lse, lse, d ** -0.5)):
        with pytest.raises(ValueError, match="runs on cuda or cpu, not meta"):
            call()


@pytest.mark.parametrize("dtypes,match", [
    ((torch.float16,) * 3, "take bf16 or fp32"),
    ((torch.float32, torch.bfloat16, torch.float32), "take one dtype"),
    ((torch.bfloat16, torch.bfloat16, torch.float32), "take one dtype")])
def test_wrappers_refuse_fp16_and_mixed_dtypes(dtypes, match):
    q, k, v = (torch.empty((1, 256, 1, 64), device="meta", dtype=dt)
               for dt in dtypes)
    with pytest.raises(ValueError, match=match):
        tfa.flash_fwd(q, k, v, 0.125)
    with pytest.raises(ValueError,
                       match="64, 256, 512 or a multiple of 8 up to 128"):
        tfa.flash_fwd(*(torch.empty((1, 256, 1, 136), device="meta")
                        for _ in range(3)), 0.125)


def test_layout_check_counts_16_bytes_by_element_size():
    # rows of 68 elements: 272 bytes in fp32 (17 x 16), 136 in bf16
    tfa.check_tma_layout(torch.zeros((2, 8, 2, 68))[..., :64], "q")
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        tfa.check_tma_layout(
            torch.zeros((2, 8, 2, 68), dtype=torch.bfloat16)[..., :64], "q")
    # rows of 66 fp32 elements: 264 bytes
    with pytest.raises(ValueError, match="multiples of 4 elements"):
        tfa.check_tma_layout(torch.zeros((2, 8, 2, 66))[..., :64], "q")
    # what the models hand over: (B, S, H*D) projections and packed ones
    for d, h in ((64, 5), (256, 1), (512, 1)):
        tfa.check_tma_layout(torch.zeros((2, 16, h * d)).view(2, 16, h, d))
        tfa.check_tma_layout(torch.zeros((2, 16, 3, h, d))[:, :, 1])


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_entry_names_and_counters(d, dtype):
    wide = "" if d == 64 else f"_d{d}"
    sfx = "_fp32" if dtype == torch.float32 else "_bf16"
    pre = ("fp32_" if dtype == torch.float32 else "") + wide[1:] + (
        "_" if wide else "")
    assert [tfa.kernel_name(kind, d, dtype) for kind in KINDS] == [
        f"flash_fwd{wide}{sfx}", f"flash_fwd_pipelined{wide}{sfx}",
        f"flash_bwd_dq{wide}{sfx}", f"flash_bwd_dkv{wide}{sfx}"]
    assert [tfa.counter_name(kind, d, dtype) for kind in KINDS] == [
        f"{pre}launches", f"{pre}pipelined_launches",
        f"{pre}bwd_dq_launches", f"{pre}bwd_dkv_launches"]
    signatures = _build._signatures()
    every = [tfa.counter_name(kind, w, dt) for kind in KINDS for w in WIDTHS
             for dt in (torch.bfloat16, torch.float32)]
    assert len(set(every)) == 24
    for kind in KINDS:
        assert tfa.kernel_name(kind, d, dtype) in signatures
    # a forward on (dtype, width, switch) counts in its own counter only
    q, k = (torch.empty((1, n, 1, d), device="meta", dtype=dtype)
            for n in (64, 4096))
    for pipelined in (False, True):
        before = {n: getattr(tfa.flash_attention, n) for n in every}
        tfa._count_forward(q, k, pipelined)
        counter = tfa.counter_name("fwd_pipelined" if pipelined else "fwd", d,
                                   dtype)
        assert {n: getattr(tfa.flash_attention, n) - before[n]
                for n in every} == {n: int(n == counter) for n in every}


def test_device_numerics_take_fp32_flash_models():
    fp32 = (UNetConfig(use_flash_attention=True),
            VAEConfig(use_flash_attention=True))
    assert all(c.dtype == torch.float32 for c in fp32)
    configure_cuda_numerics(torch.device("cuda"), *fp32)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    configure_cuda_numerics(torch.device("cuda"),
                            UNetConfig(use_flash_attention=True,
                                       dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="take bf16 or fp32"):
        configure_cuda_numerics(torch.device("cuda"),
                                VAEConfig(use_flash_attention=True,
                                          dtype=torch.float16))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")


def _held(got, ref) -> bool:
    return _rel_l2(got.cpu(), ref.cpu()) <= REL_L2


# (B*H, S, T): a training step's shape at each width and a ragged one; at
# 256 also S and T not whole 64-row clusters, and T one kv tile (the
# forwards' second exchange buffers unused)
CUDA_SHAPES = {64: [(20, 4096, 4096), (4, 1000, 577)],
               256: [(16, 4096, 4096), (2, 1000, 1500), (3, 33, 100),
                     (2, 100, 33), (2, 100, 20)],
               512: [(4, 4096, 4096), (2, 1000, 1500)]}


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t,d", [(*c, d) for d in WIDTHS
                                      for c in CUDA_SHAPES[d]])
def test_cuda_fp32_kernels_match_plain(bh, s, t, d):
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, g = (torch.randn((bh, n, d), generator=gen, device="cuda")
                  for n in (s, t, t, s))
    # each kernel held at its own tile (kernel_block_kv by kind)
    scale = d ** -0.5
    bkv, bwd_bkv = (tfa.kernel_block_kv(d, torch.float32, kind)
                    for kind in ("fwd", "bwd_dq"))
    counters = [tfa.counter_name(kind, d, torch.float32) for kind in KINDS]
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
    assert _held(o, ro) and (lse - rlse).abs().max().item() <= LSE_ABS
    ref = tfa.flash_bwd_tiled_reference(q, k, v, o, lse, g, scale, bwd_bkv)
    for name, mine, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert _held(mine, r), name
    # the TF32 mutant and dk x (1 + 1e-4) fail the bound
    assert not _held(tfa.flash_fwd_tiled_reference(q, k, v, scale, bkv,
                                                   tf32=True)[0], ro)
    assert not _held(ref[1] * (1 + 1e-4), ref[1])
    if tfa._pipelined_takes(t, d):
        po, plse = tfa.flash_fwd_3d_pipelined(q, k, v, scale)
        po2, _ = tfa.flash_fwd_3d_pipelined(q, k, v, scale)
        torch.cuda.synchronize()
        pref = tfa.flash_fwd_pipelined_reference(q, k, v, scale, bkv)
        assert torch.equal(po, po2) and _held(po, pref[0])
        assert (plse - pref[1]).abs().max().item() <= LSE_ABS


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_fp32_strided_views_give_the_contiguous_bits(d):
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    h = 5 if d == 64 else 1
    x = torch.randn((2, 1024, 4, h, d), generator=gen, device="cuda")
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
@pytest.mark.parametrize("s,t", [(33, 4096), (100, 257), (4096, 100)])
def test_cuda_fp32_d256_backward_gives_the_same_bits_on_every_cluster(s, t):
    # the 256 pair's four blocks a cluster sum their partial scores in rank
    # order and every block reads the same gathered p and ds: each output
    # the same bits run after run (with other kernels between), held to the
    # tiled plain version, two heads through the strides
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(s + t)
    d, scale = 256, 256 ** -0.5
    x = torch.randn((1, max(s, t), 4, 2, d), generator=gen, device="cuda")
    q, g = x[:, :s, 0], x[:, :s, 3]
    k, v = x[:, :t, 1], x[:, :t, 2]
    o, lse = tfa.flash_fwd(q, k, v, scale)
    rows = x.reshape(-1, d)
    runs = []
    for _ in range(3):
        runs.append(tfa.flash_bwd(q, k, v, o, lse, g, scale))
        torch.matmul(rows[:64], rows[:64].T)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))
    ref = tfa.flash_bwd_tiled_reference(
        *(tfa._to3d(y) for y in (q, k, v, o)), lse, tfa._to3d(g), scale,
        tfa.kernel_block_kv(d, torch.float32, "bwd_dq"))
    for name, mine, r in zip(("dq", "dk", "dv"), runs[0], ref):
        assert _held(tfa._to3d(mine), r), name


@pytest.mark.cuda
def test_cuda_fp16_raises_and_launches_nothing():
    _skip_without_card()
    q = torch.zeros((1, 1024, 1, 64), device="cuda", dtype=torch.float16)
    every = [tfa.counter_name(kind, w, dt) for kind in KINDS for w in WIDTHS
             for dt in (torch.bfloat16, torch.float32)]
    before = [getattr(tfa.flash_attention, n) for n in every]
    with pytest.raises(ValueError, match="take bf16 or fp32"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="take one dtype"):
        tfa.flash_attention(q.float(), q.float(), q.bfloat16())
    assert before == [getattr(tfa.flash_attention, n) for n in every]
