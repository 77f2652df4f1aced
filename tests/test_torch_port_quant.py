"""PyTorch port, int8 weight-only quantisation: the quantisers bit for bit
against the JAX package's, and the plain matmul (what a CPU tensor gets)
against JAX ``quant_matmul``.

The port keeps a weight as ``nn.Linear`` does, (N, K); the JAX package keeps
(K, N), so the comparison transposes.  The CUDA kernel is compared with the
plain version on a card (``cuda`` marker; skipped here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffute_tpu.ops import quant as jq

from diffute_tpu_torch.models.layers import QuantLinear
from diffute_tpu_torch.ops.quant import (
    convert_linear_weights_to_int8,
    dequantize,
    dequantize_blockwise,
    pack_w8_weight,
    quant_matmul,
    quant_matmul_reference,
    quantize_blockwise,
    quantize_per_channel,
    w8_plan,
)

# (M, K, N) of every int8 matmul of a flagged 512^2 UNet pass, the hoisted
# cross-attention K/V of the 577 glyph tokens, and a 1024^2 edit's widest
FLAGGED_SHAPES = [(4096, 320, 320), (4096, 320, 2560), (4096, 1280, 320),
                  (1024, 640, 640), (1024, 640, 5120), (1024, 2560, 640),
                  (256, 1280, 1280), (256, 1280, 10240), (256, 5120, 1280),
                  (64, 1280, 1280), (64, 1280, 10240), (64, 5120, 1280),
                  (577, 1024, 320), (577, 1024, 640), (577, 1024, 1280),
                  (16384, 320, 2560)]


def _weight(k, n, seed=0):
    """A (K, N) float weight with a few exact .5 ties after scaling."""
    rng = np.random.RandomState(seed)
    w = (rng.standard_normal((k, n)) * rng.uniform(0.01, 3.0, n)).astype(
        np.float32)
    w[0, :] = 127.0 * 0.01        # the column's max: scale = 0.01
    w[1, : n // 2] = 0.5 * 0.01   # ties: round half to even
    w[2, : n // 2] = 1.5 * 0.01
    return w


@pytest.mark.parametrize("k,n", [(32, 16), (96, 40), (7, 3)])
def test_quantize_per_channel_bit_for_bit(k, n):
    w = _weight(k, n)
    jq_q, jq_s = jq.quantize_per_channel(jnp.asarray(w))
    q, s = quantize_per_channel(torch.tensor(w.T.copy()))  # (N, K)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jq_s))
    np.testing.assert_array_equal(dequantize(q, s).numpy().T,
                                  np.asarray(jq.dequantize(jq_q, jq_s)))


def test_zero_column_gets_scale_one():
    w = _weight(16, 8, seed=1)
    w[:, 3] = 0.0
    q, s = quantize_per_channel(torch.tensor(w.T.copy()))
    jq_q, jq_s = jq.quantize_per_channel(jnp.asarray(w))
    assert s[3].item() == 1.0 and not q[3].any()
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jq_s))


@pytest.mark.parametrize("shape,block", [((5, 7, 3), 16), ((256,), 256),
                                         ((33, 9), 64)])
def test_quantize_blockwise_bit_for_bit(shape, block):
    x = np.random.RandomState(2).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:3] = 0.0
    jq_q, jq_s = jq.quantize_blockwise(jnp.asarray(x), block)
    q, s = quantize_blockwise(torch.tensor(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jq_s))
    back = dequantize_blockwise(q, s, shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.dequantize_blockwise(jq_q, jq_s, shape)))
    assert back.shape == shape


@pytest.mark.parametrize("lead,k,n", [((4,), 32, 16), ((2, 5), 64, 24),
                                      ((3,), 20, 6)])
def test_quant_matmul_matches_jax(lead, k, n):
    rng = np.random.RandomState(3)
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    jq_q, jq_s = jq.quantize_per_channel(jnp.asarray(_weight(k, n, seed=4)))
    ref = np.asarray(jq.quant_matmul(jnp.asarray(x), jq_q, jq_s))
    q = torch.tensor(np.asarray(jq_q).T.copy())
    s = torch.tensor(np.asarray(jq_s))
    launches = quant_matmul.launches
    out = quant_matmul(torch.tensor(x), q, s)
    assert out.shape == lead + (n,) and out.dtype == torch.float32
    # fp32 on both sides, exact int8 values: only the summation order differs
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert quant_matmul.launches == launches  # CPU: no kernel launch
    # y = (x @ q) * s is the dequantised product
    np.testing.assert_allclose(out.numpy(), x @ dequantize(q, s).numpy().T,
                               rtol=1e-4, atol=1e-4)


def test_bf16_rounds_the_product_before_the_bias():
    # QuantDense: (x @ q) * s rounded to bf16, THEN the bias added in bf16
    rng = np.random.RandomState(5)
    layer = QuantLinear(32, 8)
    q, s = quantize_per_channel(torch.tensor(rng.standard_normal((8, 32)),
                                             dtype=torch.float32))
    layer.load_state_dict({"weight_q": q, "weight_scale": s,
                           "bias": torch.tensor(rng.standard_normal(8),
                                                dtype=torch.float32)})
    layer = layer.to(torch.bfloat16)
    assert layer.weight_q.dtype == torch.int8          # the cast leaves int8
    assert layer.weight_scale.dtype == torch.bfloat16  # and rounds the scale
    x = torch.tensor(rng.standard_normal((4, 32)), dtype=torch.bfloat16)
    y = layer(x)
    prod = ((x.float() @ q.float().t()) * s.bfloat16().float()).bfloat16()
    assert torch.equal(y, prod + layer.bias)
    assert torch.equal(quant_matmul_reference(x, q, s.bfloat16()), prod)


@pytest.mark.parametrize("scale_bf16", [False, True])
@pytest.mark.parametrize("m,k,n", [(4, 64, 16), (7, 96, 24)])
def test_reference_bias_is_jax_rounding_then_bias(m, k, n, scale_bf16):
    # y = bf16(bf16(acc * s) + bias): _xla_matmul_w8 rounded to bf16, then
    # QuantDense's bias in bf16.  Small integer x makes every sum exact in
    # fp32 whatever its order, so the two sides agree bit for bit.
    rng = np.random.RandomState(7)
    x = rng.randint(-8, 9, size=(m, k)).astype(np.float32)
    jq_q, jq_s = jq.quantize_per_channel(jnp.asarray(_weight(k, n, seed=8)))
    bias = rng.standard_normal(n).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    js = jq_s.astype(jnp.bfloat16) if scale_bf16 else jq_s
    ref = (jq._xla_matmul_w8(xb, jq_q, js).astype(jnp.bfloat16)
           + jnp.asarray(bias).astype(jnp.bfloat16))
    q = torch.tensor(np.asarray(jq_q).T.copy())
    s = torch.tensor(np.asarray(jq_s))
    if scale_bf16:
        s = s.bfloat16()
    out = quant_matmul_reference(torch.tensor(x).bfloat16(), q, s,
                                 torch.tensor(bias))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    # the wrapper's CPU path is that function, the bias passed in
    assert torch.equal(quant_matmul(torch.tensor(x).bfloat16(), q, s,
                                    torch.tensor(bias)), out)


def test_pack_w8_weight_layout():
    # (N, K) int8 -> (K steps of 64, 64-feature tiles (even), 4096 bytes):
    # thread lane = 4g + t of warp w reads 16 bytes of feature 16w + g, then
    # 16 of feature 16w + g + 8, each k = 16kk + (2t, 2t+1, 2t+8, 2t+9),
    # biased by 128; past N and K the bytes read as q = 0
    rng = np.random.RandomState(9)
    q = torch.tensor(rng.randint(-127, 128, size=(200, 80)), dtype=torch.int8)
    packed = pack_w8_weight(q)
    assert packed.shape == (2, 4, 4096) and packed.dtype == torch.uint8
    assert packed.is_contiguous()
    for f, kidx in [(0, 0), (5, 17), (199, 79), (63, 63), (64, 64), (130, 9)]:
        tile, w, half, g = f // 64, (f % 64) // 16, (f % 16) // 8, f % 8
        kk, rem = (kidx % 64) // 16, kidx % 16
        hb, t, e = rem // 8, (rem % 8) // 2, rem % 2
        byte = (((w * 2 + half) * 32 + 4 * g + t) * 16) + kk * 4 + hb * 2 + e
        assert packed[kidx // 64, tile, byte] == int(q[f, kidx]) + 128
    # the padding: features 200..255 and k 80..127
    assert packed.int().sum() == (int(q.int().sum()) + 128 * 2 * 4 * 4096)


@pytest.mark.parametrize("m,k,n", FLAGGED_SHAPES + [(3, 48, 10)])
def test_plan_covers_the_output_with_no_empty_split(m, k, n):
    plan = w8_plan(m, n, k)
    bt, splits = plan["tokens_per_block"], plan["splits"]
    assert bt in (64, 128)
    assert plan["tiles"] == -(-m // bt) * -(-n // 128)  # every (M, N) tile
    steps = -(-k // 64)
    per = -(-steps // splits)
    assert 1 <= splits <= steps and (splits - 1) * per < steps
    assert plan["blocks"] == plan["tiles"] * splits
    # the choices measured on an H100: 128 tokens at M >= 2048 or N >= 4096,
    # a split only at K = 5120 where the tiles leave SMs idle
    assert bt == (128 if m >= 2048 or n >= 4096 else 64)
    assert (splits > 1) == (k >= 5120 and plan["tiles"] < 132)


def test_convert_state_dict_rewrites_only_the_named_layers():
    rng = np.random.RandomState(6)
    sd = {"a.weight": torch.tensor(rng.standard_normal((4, 6)), dtype=torch.float32),
          "a.bias": torch.zeros(4),
          "b.weight": torch.tensor(rng.standard_normal((3, 4)), dtype=torch.float32)}
    out = convert_linear_weights_to_int8(sd, ["a"])
    assert sorted(out) == ["a.bias", "a.weight_q", "a.weight_scale", "b.weight"]
    q, s = quantize_per_channel(sd["a.weight"])
    assert torch.equal(out["a.weight_q"], q)
    assert torch.equal(out["a.weight_scale"], s)
    assert out["b.weight"] is sd["b.weight"] and "a.weight" in sd  # no mutation


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((8, 32), dtype=torch.int8)
    with pytest.raises(ValueError):  # K mismatch
        quant_matmul(torch.zeros(2, 16), q, torch.ones(8))
    with pytest.raises(ValueError):  # q must be int8
        quant_matmul(torch.zeros(2, 32), q.float(), torch.ones(8))
    with pytest.raises(ValueError):  # neither cuda nor cpu: no fallback
        quant_matmul(torch.zeros((2, 32), device="meta"), q.to("meta"),
                     torch.ones(8, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 320, 320), (4096, 320, 2560),
                                   (4096, 1280, 320),
                                   (1024, 640, 5120), (256, 5120, 1280),
                                   (64, 5120, 1280), (64, 1280, 10240),
                                   (577, 1024, 640), (3, 48, 10)])
def test_cuda_kernel_matches_plain(m, k, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
    q, s = quantize_per_channel(
        torch.randn((n, k), generator=g, device="cuda") * k ** -0.5)
    bias = torch.randn(n, generator=g, device="cuda").bfloat16()
    packed = pack_w8_weight(q)
    for scale in (s, s.bfloat16()):
        before = quant_matmul.launches
        y = quant_matmul(x, q, scale, packed=packed)
        again = quant_matmul(x, q, scale, packed=packed)
        y_bias = quant_matmul(x, q, scale, bias, packed=packed)
        torch.cuda.synchronize()
        assert quant_matmul.launches == before + 3
        assert torch.equal(y, again)  # deterministic, split or not
        # the bias in the epilogue equals the two-step, bit for bit
        assert torch.equal(y_bias, y + bias)
        ref = quant_matmul_reference(x, q, scale).float()
        # one fp32 result rounded to bf16 on both sides: 3 half-ulps of
        # max |ref| and a relative L2 error of 2e-3 (no scale gives O(1), the
        # output scaled by 0.99 1e-2)
        diff = y.float() - ref
        assert diff.abs().max().item() <= 3 * ref.abs().max().item() * 2 ** -8
        assert (diff.norm() / ref.norm()).item() <= 2e-3
        assert ((y.float() * 0.99 - ref).norm() / ref.norm()).item() > 2e-3
    # packed in the call when not given
    assert torch.equal(quant_matmul(x, q, s), quant_matmul(x, q, s,
                                                           packed=packed))
    with pytest.raises(ValueError):
        quant_matmul(x.float(), q, s)  # no fallback


@pytest.mark.cuda
def test_cuda_two_streams_do_not_share_ticket_counters(monkeypatch):
    # the split-K int8 matmul merges its blocks' partial results by ticket
    # counters, the GroupNorm statistics inside a thread block cluster;
    # launches of both in flight on two streams at once must give what each
    # gives alone, bit for bit
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from diffute_tpu_torch.ops import groupnorm as gn
    from diffute_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn((1, 320, 64, 64), generator=g, device="cuda").bfloat16()
          for _ in range(2)]
    ms = [torch.randn((256, 5120), generator=g, device="cuda").bfloat16()
          for _ in range(2)]
    q, scale = quant.quantize_per_channel(
        torch.randn((1280, 5120), generator=g, device="cuda") * 5120 ** -0.5)
    scale = scale.bfloat16()

    def work(i):
        return (*gn.group_norm_stats(xs[i], 32, 1e-5),
                quant.quant_matmul(ms[i], q, scale, splits=4))

    alone = [work(i) for i in range(2)]
    torch.cuda.synchronize()

    def mismatches():
        """Launches that differ from the run alone, of 2 x 5 x 20 queued on
        two streams behind one gate, so that both queues run at once."""
        streams = [torch.cuda.Stream() for _ in range(2)]
        bad = 0
        for _ in range(5):
            torch.cuda._sleep(200_000_000)
            gate = torch.cuda.Event()
            gate.record()
            outs = []
            for i, s in enumerate(streams):
                s.wait_event(gate)
                with torch.cuda.stream(s):
                    outs.append([work(i) for _ in range(20)])
            torch.cuda.synchronize()
            bad += sum(not all(torch.equal(a, b) for a, b in zip(run, alone[i]))
                       for i, runs in enumerate(outs) for run in runs)
        return bad

    assert mismatches() == 0
    # the check sees the fault: one buffer for both streams gives wrong sums
    shared = torch.zeros(8192, dtype=torch.int32, device="cuda")
    monkeypatch.setattr(quant, "stream_tickets", lambda *a: shared)
    assert mismatches() > 0
