"""PyTorch port, GroupNorm kernels' grid and merge (no card needed).

``gn_plan`` is the grid both kernels of ``csrc/groupnorm.cu`` launch with: a
thread block cluster of up to 8 blocks per (sample, group), each block one
contiguous piece of the group's run.  It is checked at every GroupNorm shape
of a flagged UNet pass at 512^2, 768^2 and 1024^2, batch 1 and 2.
``group_norm_stats_tiled_reference`` folds the plan's pieces in rank order
with Chan's formula, as the kernels do; it is held against the plain
statistics, float64 numpy and the JAX op (the Pallas kernel in interpret
mode, as tests/test_groupnorm.py runs it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffute_tpu.ops.groupnorm import group_norm_silu as j_group_norm_silu

from diffute_tpu_torch.ops.groupnorm import (
    MAX_CLUSTER,
    MAX_SMEM,
    gn_plan,
    group_norm_silu_from_stats,
    group_norm_stats_reference,
    group_norm_stats_tiled_reference,
)
from port_threads import torch_threads_per_worker  # noqa: F401

# every GroupNorm of a flagged UNet pass at 512^2 (SD2: 320/640/1280/1280
# channels, two resnets a level): (C, H = W).  The fused conv launches the
# statistics at each; with use_fused_groupnorm alone GN+SiLU runs at each,
# conv_norm_out's (320, 64) included.  Other resolutions scale H.
NORM_SHAPES = [(320, 64), (640, 64), (960, 64), (320, 32), (640, 32),
               (960, 32), (1280, 32), (1920, 32), (640, 16), (1280, 16),
               (1920, 16), (2560, 16), (1280, 8), (2560, 8)]
SMS = 132


def _check_plan(b, c, h, w, groups=32):
    p = gn_plan(b, c, h, w, groups)
    n_vec = (c // groups) * h * w // 8
    assert p["n_vec"] == n_vec
    assert 1 <= p["cluster"] <= MAX_CLUSTER == 8
    assert p["cluster"] & (p["cluster"] - 1) == 0
    assert p["per"] == -(-n_vec // p["cluster"])
    # no piece is empty: the last block owns at least one vector
    assert n_vec - p["per"] * (p["cluster"] - 1) >= 1
    for width in (p["threads"], p["silu_threads"]):
        assert 32 <= width <= 1024 and width % 32 == 0
    assert p["blocks"] == b * groups * p["cluster"]
    assert p["smem"] == 16 * p["staged"] + 8 * (c // groups) <= MAX_SMEM
    return p


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("res", [512, 768, 1024])
def test_plan_at_every_norm_shape_of_a_flagged_pass(res, batch):
    for c, hw in NORM_SHAPES:
        hw = hw * res // 512
        p = _check_plan(batch, c, hw, hw)
        # every UNet shape is one launch with x read once: the whole piece
        # fits the shared memory it is given
        assert p["one_read"] and p["staged"] == p["per"]
        if hw == 64:  # the blocks cover the card's SMs at 64^2
            assert p["blocks"] >= SMS


def test_plan_of_a_slab_beyond_the_clusters_shared_memory():
    # the VAE decoder's 128 channels at 512^2: 2 MB a group, more than eight
    # blocks' shared memory; the rest of each piece is read again
    p = _check_plan(1, 128, 512, 512)
    assert p["cluster"] == 8 and not p["one_read"]
    assert 0 < p["staged"] < p["per"] and p["smem"] <= MAX_SMEM


@pytest.mark.parametrize("groups", [1, 4, 32])
@pytest.mark.parametrize("b", [1, 2, 5])
def test_plan_never_leaves_a_piece_empty(b, groups):
    for cpg in (1, 2, 3, 8):
        for hw in (8, 16, 24, 40, 64, 72, 200, 256, 1000, 4096):
            if cpg * hw % 8 == 0:
                _check_plan(b, cpg * groups, 1, hw, groups)


def test_plan_rejects_a_run_that_is_not_whole_vectors():
    with pytest.raises(ValueError):
        gn_plan(1, 32, 3, 3, 32)
    with pytest.raises(ValueError):
        gn_plan(1, 30, 8, 8, 32)


def _case(shape_nhwc, seed, mean):
    rng = np.random.RandomState(seed)
    c = shape_nhwc[-1]
    x = (rng.standard_normal(shape_nhwc) + mean).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("mean", [0.0, 100.0])
@pytest.mark.parametrize("shape,groups,ranks", [
    ((2, 16, 16, 64), 4, 1),     # a group of one block
    ((2, 32, 32, 640), 32, 4),   # batch 2: four ranks
    ((1, 32, 32, 640), 32, 8),   # the 32^2 level's 640 channels: eight
])
def test_tiled_reference_matches_plain_numpy_and_jax(shape, groups, ranks,
                                                     mean):
    x, scale, bias = _case(shape, seed=ranks, mean=mean)
    xt = torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    assert gn_plan(*xt.shape, groups)["cluster"] == ranks
    mean_t, rstd_t = group_norm_stats_tiled_reference(xt, groups, 1e-5)
    mean_p, rstd_p = group_norm_stats_reference(xt, groups, 1e-5)
    # fp32 on both sides, sums in another order: the mean to 1e-6 of its
    # size, rstd to 1e-5 relative
    np.testing.assert_allclose(mean_t.numpy(), mean_p.numpy(), rtol=0,
                               atol=1e-6 * max(1.0, mean))
    np.testing.assert_allclose(rstd_t.numpy(), rstd_p.numpy(), rtol=1e-5)
    # float64 numpy: exact to 1e-5 only if the variance did not cancel
    # (|mean| = 100 >> std = 1)
    xd = x.astype(np.float64).transpose(0, 3, 1, 2).reshape(shape[0], groups, -1)
    mu = xd.mean(axis=2)
    var = ((xd - mu[..., None]) ** 2).mean(axis=2)
    np.testing.assert_allclose(mean_t.numpy(), mu, rtol=0,
                               atol=1e-6 * max(1.0, mean))
    np.testing.assert_allclose(rstd_t.numpy(), 1 / np.sqrt(var + 1e-5),
                               rtol=1e-5)
    # the JAX op on the same input: its output from the tiled statistics, to
    # 1e-4 (the Pallas kernel takes E[x^2] - mean^2 in fp32, which at mean
    # 100 the JAX package's plain reference replaces: both are compared)
    y = group_norm_silu_from_stats(xt, torch.tensor(scale), torch.tensor(bias),
                                   mean_t, rstd_t)
    y = y.permute(0, 2, 3, 1).numpy()
    use_pallas = mean == 0.0
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_group_norm_silu(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups,
            1e-5, use_pallas=use_pallas))
    np.testing.assert_allclose(y, ref, atol=1e-4, rtol=1e-4)


def test_tiled_reference_folds_exactly_the_ranks_it_is_given():
    x, _, _ = _case((1, 32, 32, 640), seed=3, mean=0.0)
    xt = torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    p = gn_plan(*xt.shape, 32)
    assert p["cluster"] == 8
    # rank 0 alone is the statistics of the first piece of each group
    mean0, rstd0 = group_norm_stats_tiled_reference(xt, 32, 1e-5, ranks=[0])
    piece = xt.reshape(32, -1)[:, :8 * p["per"]].reshape(1, 32, -1, 1)
    mean_r, rstd_r = group_norm_stats_reference(piece, 32, 1e-5)
    np.testing.assert_allclose(mean0.numpy(), mean_r.numpy(), atol=1e-7)
    np.testing.assert_allclose(rstd0.numpy(), rstd_r.numpy(), rtol=1e-6)
    # a dropped rank moves the statistics far outside the kernels' tolerance
    # (mean 1e-5, rstd 1e-4 relative): the mutant chip_smoke.py must reject
    mean_d, rstd_d = group_norm_stats_tiled_reference(xt, 32, 1e-5,
                                                      ranks=range(1, 8))
    mean_f, rstd_f = group_norm_stats_tiled_reference(xt, 32, 1e-5)
    assert (mean_d - mean_f).abs().max() > 1e-3
    assert ((rstd_d - rstd_f).abs() / rstd_f).max() > 1e-3
