"""TrOCR text decoder and greedy decoding (the OCR verifier's reader).

Counterpart of ``diffute_tpu/models/trocr_decoder.py`` with transformers'
``TrOCRForCausalLM`` module tree under ``model.decoder`` (``embed_tokens``,
``embed_positions``, ``layernorm_embedding``, ``layers.i.self_attn.q_proj``,
...), so a state_dict with that prefix stripped loads with
``load_state_dict(strict=True)`` (``compat.diffusers.import_trocr_decoder_
state_dict``).  BART-style post-LN: scaled word embeddings plus learned
positions at offset 2, optional embedding LayerNorm, N layers of [causal
self-attention -> LN -> cross-attention over the encoder tokens -> LN ->
GELU (erf) FFN -> LN], and logits tied to ``embed_tokens``.  Every
attention is the port's :func:`~diffute_tpu_torch.ops.dense_attention`:
fp32 logits, -1e30 where masked, softmax, cast.

Two generation paths, token-identical:
- :func:`greedy_decode` re-runs the decoder over the whole fixed-length
  buffer at every position (O(L^2), no cache);
- :func:`greedy_decode_cached` keeps one self-attention K/V buffer per
  layer, filled in place at each position, and projects the
  cross-attention K/V once (O(L)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffute_tpu_torch.ops import dense_attention

KV = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrOCRDecoderConfig:
    """Defaults = microsoft/trocr-large-printed decoder."""

    vocab_size: int = 50265
    hidden_size: int = 1024
    decoder_layers: int = 12
    decoder_attention_heads: int = 16
    decoder_ffn_dim: int = 4096
    max_position_embeddings: int = 512
    scale_embedding: bool = True
    layernorm_embedding: bool = True
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    dtype: torch.dtype = torch.float32


def small_decoder_config() -> TrOCRDecoderConfig:
    """Char-level decoder matching ``config.small_config()``'s encoder and
    ``text.CharTokenizer``'s vocabulary (train/run_ocr.py, eval
    --model_scale small)."""
    from diffute_tpu_torch.text.char_tokenizer import VOCAB_SIZE

    return TrOCRDecoderConfig(
        vocab_size=VOCAB_SIZE, hidden_size=256, decoder_layers=2,
        decoder_attention_heads=4, decoder_ffn_dim=1024,
        max_position_embeddings=128)


def decoder_config_json(config: TrOCRDecoderConfig, tokenizer: str) -> dict:
    """The ``trocr_decoder/config.json`` fields the JAX package writes."""
    return {"model_type": "trocr", "tokenizer": tokenizer,
            "vocab_size": config.vocab_size,
            "hidden_size": config.hidden_size,
            "decoder_layers": config.decoder_layers,
            "decoder_attention_heads": config.decoder_attention_heads,
            "decoder_ffn_dim": config.decoder_ffn_dim,
            "max_position_embeddings": config.max_position_embeddings}


class TrOCRAttention(nn.Module):
    def __init__(self, cfg: TrOCRDecoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.decoder_attention_heads
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.q_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape
        return x.view(b, t, self.num_heads, h // self.num_heads)

    def kv(self, context: torch.Tensor) -> KV:
        """(B, T, H*D) context -> (k, v) of (B, T, H, D)."""
        return self._split(self.k_proj(context)), self._split(self.v_proj(context))

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = dense_attention(q, k, v, q.shape[-1] ** -0.5, mask)
        b, s = out.shape[:2]
        return self.out_proj(out.reshape(b, s, -1))

    def forward(self, x: torch.Tensor, kv_input: torch.Tensor,
                causal: bool = False) -> torch.Tensor:
        mask = None
        if causal:
            s, t = x.shape[1], kv_input.shape[1]
            mask = torch.ones((s, t), dtype=torch.bool,
                              device=x.device).tril()
        return self.attend(self._split(self.q_proj(x)), *self.kv(kv_input),
                           mask=mask)

    def step(self, x1: torch.Tensor, cache: KV, pos: int) -> torch.Tensor:
        """One-token self-attention: x1 (B, 1, H*D); ``cache`` (k, v) of
        (B, L, H, D) is written in place at ``pos`` and attended over the
        positions <= pos."""
        k_buf, v_buf = cache
        k1, v1 = self.kv(x1)
        k_buf[:, pos] = k1[:, 0]
        v_buf[:, pos] = v1[:, 0]
        valid = torch.arange(k_buf.shape[1], device=x1.device) <= pos
        return self.attend(self._split(self.q_proj(x1)), k_buf, v_buf,
                           mask=valid)


class TrOCRDecoderLayer(nn.Module):
    def __init__(self, cfg: TrOCRDecoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.self_attn = TrOCRAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(h, eps=1e-5)
        self.encoder_attn = TrOCRAttention(cfg)
        self.encoder_attn_layer_norm = nn.LayerNorm(h, eps=1e-5)
        self.fc1 = nn.Linear(h, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, h)
        self.final_layer_norm = nn.LayerNorm(h, eps=1e-5)

    def _tail(self, x: torch.Tensor, cross: torch.Tensor) -> torch.Tensor:
        x = self.encoder_attn_layer_norm(x + cross)
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.final_layer_norm(x + h)

    def forward(self, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x, x, causal=True))
        return self._tail(x, self.encoder_attn(x, enc))

    def step(self, x1: torch.Tensor, cache: KV, enc_kv: KV,
             pos: int) -> torch.Tensor:
        x1 = self.self_attn_layer_norm(x1 + self.self_attn.step(x1, cache, pos))
        attn = self.encoder_attn
        cross = attn.attend(attn._split(attn.q_proj(x1)), *enc_kv)
        return self._tail(x1, cross)


class TrOCRDecoder(nn.Module):
    """(B, L) token ids + (B, T, hidden) encoder states -> (B, L, vocab)."""

    def __init__(self, config: TrOCRDecoderConfig = TrOCRDecoderConfig()):
        super().__init__()
        cfg = self.config = config
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        # learned positions with TrOCR's offset of 2
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + 2,
                                            cfg.hidden_size)
        self.layernorm_embedding = (nn.LayerNorm(cfg.hidden_size, eps=1e-5)
                                    if cfg.layernorm_embedding else None)
        self.layers = nn.ModuleList(TrOCRDecoderLayer(cfg)
                                    for _ in range(cfg.decoder_layers))

    def _embed(self, input_ids: torch.Tensor, pos_offset: int = 0
               ) -> torch.Tensor:
        cfg = self.config
        scale = math.sqrt(cfg.hidden_size) if cfg.scale_embedding else 1.0
        x = self.embed_tokens(input_ids) * scale
        start = 2 + pos_offset
        x = x + self.embed_positions.weight[start:start + input_ids.shape[1]]
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.embed_tokens.weight)  # tied

    def forward(self, input_ids: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        x = self._embed(input_ids)
        enc = encoder_hidden_states.to(x.dtype)
        for layer in self.layers:
            x = layer(x, enc)
        return self._logits(x)

    # -- cached decoding ---------------------------------------------------

    def cross_kvs(self, encoder_hidden_states: torch.Tensor) -> List[KV]:
        enc = encoder_hidden_states.to(self.embed_tokens.weight.dtype)
        return [layer.encoder_attn.kv(enc) for layer in self.layers]

    def decode_step(self, token: torch.Tensor, caches: List[KV],
                    enc_kvs: List[KV], pos: int) -> torch.Tensor:
        """token (B, 1) at position ``pos`` -> logits (B, vocab); the caches
        are written in place."""
        x1 = self._embed(token, pos_offset=pos)
        for layer, cache, enc_kv in zip(self.layers, caches, enc_kvs):
            x1 = layer.step(x1, cache, enc_kv, pos)
        return self._logits(x1)[:, 0]


def _pick(logits: torch.Tensor, done: torch.Tensor, cfg: TrOCRDecoderConfig):
    """Greedy choice, PAD once a row has emitted EOS; (next, done)."""
    nxt = torch.argmax(logits, dim=-1)
    nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id), nxt)
    return nxt, done | (nxt == cfg.eos_token_id)


@torch.no_grad()
def greedy_decode(decoder: TrOCRDecoder, encoder_hidden_states: torch.Tensor,
                  max_len: int = 32) -> torch.Tensor:
    """Greedy generation, uncached -> (B, max_len) int64 token ids
    (PAD-filled after EOS)."""
    cfg = decoder.config
    b, dev = encoder_hidden_states.shape[0], encoder_hidden_states.device
    ids = torch.full((b, max_len + 1), cfg.pad_token_id, dtype=torch.long,
                     device=dev)
    ids[:, 0] = cfg.decoder_start_token_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(max_len):
        logits = decoder(ids[:, :-1], encoder_hidden_states)
        ids[:, i + 1], done = _pick(logits[:, i], done, cfg)
    return ids[:, 1:]


@torch.no_grad()
def greedy_decode_cached(decoder: TrOCRDecoder,
                         encoder_hidden_states: torch.Tensor,
                         max_len: int = 32) -> torch.Tensor:
    """KV-cached greedy generation, one single-token decoder pass per
    position; token-identical to :func:`greedy_decode`."""
    cfg = decoder.config
    b, dev = encoder_hidden_states.shape[0], encoder_hidden_states.device
    heads = cfg.decoder_attention_heads
    enc_kvs = decoder.cross_kvs(encoder_hidden_states)
    shape = (b, max_len, heads, cfg.hidden_size // heads)
    caches = [(enc_kvs[0][0].new_zeros(shape), enc_kvs[0][0].new_zeros(shape))
              for _ in range(cfg.decoder_layers)]
    ids = torch.full((b, max_len), cfg.pad_token_id, dtype=torch.long,
                     device=dev)
    tok = torch.full((b, 1), cfg.decoder_start_token_id, dtype=torch.long,
                     device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(max_len):
        logits = decoder.decode_step(tok, caches, enc_kvs, i)
        ids[:, i], done = _pick(logits, done, cfg)
        tok = ids[:, i:i + 1]
    return ids
