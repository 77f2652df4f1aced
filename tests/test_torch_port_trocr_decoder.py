"""PyTorch port, the TrOCR text decoder against the JAX package's, fp32 on
the CPU.

Both sides get the same weights: the JAX init's params through
``compat.trocr_decoder_state_dict`` into ``load_state_dict(strict=True)``.

- logits within atol 1e-5 (fp32 on both sides, other summation orders:
  1.3e-7 measured, on logits up to 0.45);
- ``greedy_decode`` and ``greedy_decode_cached`` token for token against
  both JAX decodes, and the port's two decodes equal;
- the stop at EOS: a decoder built to read 3, 4, 5, EOS emits PAD after it
  on both sides;
- the bridge key for key against ``export_trocr_decoder_state_dict``, and
  the HF-layout export / import pair round trip across the stacks and with
  transformers' own ``TrOCRForCausalLM`` state_dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffute_tpu.models import trocr_decoder as jdec

from diffute_tpu_torch.compat import trocr_decoder_state_dict
from diffute_tpu_torch.compat.diffusers import (
    export_trocr_decoder_state_dict,
    import_trocr_decoder_state_dict,
)
from diffute_tpu_torch.models.trocr_decoder import (
    TrOCRDecoder,
    TrOCRDecoderConfig,
    greedy_decode,
    greedy_decode_cached,
)
from diffute_tpu_torch.utils.params import load_module
from port_threads import torch_threads_per_worker  # noqa: F401

DIMS = dict(vocab_size=50, hidden_size=32, decoder_layers=2,
            decoder_attention_heads=2, decoder_ffn_dim=64,
            max_position_embeddings=64)
T_ENC = 9


def _jax_params(jcfg, seed):
    enc = jnp.zeros((1, T_ENC, jcfg.hidden_size))
    return jax.device_get(jdec.TrOCRDecoder(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32), enc)["params"])


def _port(jparams, **kw):
    cfg = TrOCRDecoderConfig(**{**DIMS, **kw})
    return load_module(TrOCRDecoder, cfg, trocr_decoder_state_dict(jparams),
                       "cpu", torch.float32)


@pytest.fixture(scope="module")
def pair():
    jcfg = jdec.TrOCRDecoderConfig(**DIMS)
    jparams = _jax_params(jcfg, 1)
    return jcfg, jparams, _port(jparams)


def test_logits_match_jax(pair):
    jcfg, jparams, dec = pair
    rng = np.random.RandomState(0)
    ids = rng.randint(0, DIMS["vocab_size"], (2, 7)).astype(np.int32)
    enc = rng.randn(2, T_ENC, DIMS["hidden_size"]).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jdec.TrOCRDecoder(jcfg).apply(
            {"params": jparams}, jnp.asarray(ids), jnp.asarray(enc)))
    with torch.no_grad():
        got = dec(torch.from_numpy(ids).long(), torch.from_numpy(enc)).numpy()
    assert got.shape == ref.shape == (2, 7, DIMS["vocab_size"])
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_greedy_decodes_match_jax_token_for_token(pair):
    jcfg, jparams, dec = pair
    # encoder states scaled up so the reads vary across rows and positions
    enc = 3 * np.random.RandomState(5).randn(6, T_ENC, 32).astype(np.float32)
    model = jdec.TrOCRDecoder(jcfg)
    with jax.default_matmul_precision("highest"):
        j_plain = np.asarray(jdec.greedy_decode(model, jparams,
                                                jnp.asarray(enc), max_len=10))
        j_cached = np.asarray(jdec.greedy_decode_cached(
            model, jparams, jnp.asarray(enc), max_len=10))
    t_enc = torch.from_numpy(enc)
    plain = greedy_decode(dec, t_enc, max_len=10).numpy()
    cached = greedy_decode_cached(dec, t_enc, max_len=10).numpy()
    assert plain.shape == (6, 10)
    np.testing.assert_array_equal(j_plain, j_cached)
    np.testing.assert_array_equal(plain, j_plain)
    np.testing.assert_array_equal(cached, j_cached)
    np.testing.assert_array_equal(cached, plain)
    # not a constant read: the comparison above is not vacuous
    assert len(np.unique(plain)) > 2


def _reader_of(targets, eos, vocab=12, hidden=32, seed=0):
    """JAX params of a 1-layer decoder that reads ``targets[p]`` at
    position p whatever the tokens before it: orthonormal token rows
    orthogonal to the all-ones vector (so LayerNorm only rescales), the
    position rows pointing at the target, the attention and FFN outputs
    zeroed so the residual stream is the embedding alone."""
    q, _ = np.linalg.qr(np.concatenate(
        [np.ones((hidden, 1)), np.random.RandomState(seed).randn(hidden, vocab)],
        axis=1))
    rows = q[:, 1:vocab + 1].T.astype(np.float32)        # (vocab, hidden)
    jcfg = jdec.TrOCRDecoderConfig(
        vocab_size=vocab, hidden_size=hidden, decoder_layers=1,
        decoder_attention_heads=2, decoder_ffn_dim=16,
        max_position_embeddings=32)
    p = _jax_params(jcfg, seed)
    p = jax.tree_util.tree_map(np.array, p)
    p["embed_tokens"] = rows
    pos = np.zeros_like(p["embed_positions"])
    for i, t in enumerate(targets):
        pos[2 + i] = 20.0 * rows[t]
    p["embed_positions"] = pos
    layer = p["layers_0"]
    for name in ("self_attn", "encoder_attn"):
        for leaf in ("kernel", "bias"):
            layer[name]["out_proj"][leaf][...] = 0
    for leaf in ("kernel", "bias"):
        layer["fc2"][leaf][...] = 0
    return jcfg, p


def test_decodes_stop_at_eos_and_pad_after():
    eos, pad = 2, 1
    targets = [3, 4, 5, eos, 6, 7, 8, 9]  # positions past the EOS read on
    jcfg, jparams = _reader_of(targets, eos)
    dec = load_module(TrOCRDecoder, TrOCRDecoderConfig(
        vocab_size=12, hidden_size=32, decoder_layers=1,
        decoder_attention_heads=2, decoder_ffn_dim=16,
        max_position_embeddings=32), trocr_decoder_state_dict(jparams),
        "cpu", torch.float32)
    enc = np.random.RandomState(1).randn(2, T_ENC, 32).astype(np.float32)
    want = np.array([3, 4, 5, eos, pad, pad, pad, pad])
    for fn in (greedy_decode, greedy_decode_cached):
        got = fn(dec, torch.from_numpy(enc), max_len=8).numpy()
        np.testing.assert_array_equal(got, np.stack([want, want]))
    model = jdec.TrOCRDecoder(jcfg)
    for fn in (jdec.greedy_decode, jdec.greedy_decode_cached):
        np.testing.assert_array_equal(
            np.asarray(fn(model, jparams, jnp.asarray(enc), max_len=8)),
            np.stack([want, want]))


def test_bridge_key_for_key(pair):
    _, jparams, dec = pair
    mine = trocr_decoder_state_dict(jparams)
    theirs = jdec.export_trocr_decoder_state_dict(jparams)
    prefix = "model.decoder."
    assert all(k.startswith(prefix) for k in theirs)
    assert set(mine) == {k[len(prefix):] for k in theirs}
    assert set(mine) == set(dec.state_dict())
    for k, v in mine.items():
        np.testing.assert_array_equal(v.numpy(), theirs[prefix + k])


def test_hf_layout_round_trips_across_stacks(pair):
    _, jparams, dec = pair
    sd = dec.state_dict()
    # port -> HF layout -> JAX import: JAX's own params
    exported = {k: v.numpy() for k, v in
                export_trocr_decoder_state_dict(sd).items()}
    back = jdec.import_trocr_decoder_state_dict(exported)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    # JAX export -> port import: the port's state_dict, loadable strictly
    mine = import_trocr_decoder_state_dict(
        jdec.export_trocr_decoder_state_dict(jparams))
    assert set(mine) == set(sd)
    for k in sd:
        assert torch.equal(mine[k], sd[k]), k
    load_module(TrOCRDecoder, dec.config, mine, "cpu", torch.float32)
    # a VisionEncoderDecoder-style prefix and a tied output projection
    nested = {"decoder." + k: v for k, v in
              export_trocr_decoder_state_dict(sd).items()}
    nested["decoder.output_projection.weight"] = sd["embed_tokens.weight"]
    assert set(import_trocr_decoder_state_dict(nested)) == set(sd)


def test_transformers_trocr_state_dict_loads_strictly():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.TrOCRConfig(
        vocab_size=50, d_model=32, decoder_layers=2,
        decoder_attention_heads=2, decoder_ffn_dim=64,
        max_position_embeddings=64, cross_attention_hidden_size=None,
        scale_embedding=True, layernorm_embedding=True,
        use_learned_position_embeddings=True, activation_function="gelu",
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        is_decoder=True, add_cross_attention=True)
    torch.manual_seed(0)
    hf = transformers.TrOCRForCausalLM(hf_cfg).eval()
    dec = load_module(TrOCRDecoder, TrOCRDecoderConfig(**DIMS),
                      import_trocr_decoder_state_dict(hf.state_dict()), "cpu",
                      torch.float32)
    rng = np.random.RandomState(2)
    ids = torch.from_numpy(rng.randint(0, 50, (2, 7)))
    enc = torch.from_numpy(rng.randn(2, T_ENC, 32).astype(np.float32))
    with torch.no_grad():
        ref = hf(input_ids=ids, encoder_hidden_states=enc).logits
        got = dec(ids, enc)
    torch.testing.assert_close(got, ref, atol=3e-5, rtol=1e-4)
