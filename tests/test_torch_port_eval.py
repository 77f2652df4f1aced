"""PyTorch port, eval (quality metrics, the OCR verifier, the eval CLI)
against the JAX package's, at tiny scale on the CPU.

- ``ssim`` / ``psnr``: the same numpy float64 arithmetic, equal numbers.
- ``OCRVerifier.read`` token for token on the same uint8 crops, cached and
  uncached; the decoder's weights are scaled up (dense kernels x2,
  positions x50) so that random-init reads vary across crops and
  positions instead of repeating one token.
- ``eval.run --tiny --synthetic 2 --steps 2`` from one JAX-exported layout
  (with that decoder as ``trocr_decoder/``), plain, with ``--cross_text``
  and with ``--cross_text_novel``, the last two with ``--tokenizer char``:
  the port takes the JAX key-tree draws (rbg) through ``_draw_noise`` and
  JAX's uint8 resize is held on its native route (the port's arithmetic).
  The edited images and crops are within 1 LSB (8 of 12 differed by 1 LSB
  somewhere when this was written: fp32 on both sides, other summation
  orders).  Every report field matches: strings, booleans, ids and boxes
  exactly, the SSIM / PSNR values and the in-box mean |delta| within 1e-3
  of max(1, |value|) (measured: 3.9e-4 at most, on a mean |delta| near
  100; the SSIMs to 2e-6).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffute_tpu.compat import save_safetensors as j_save_safetensors
from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.eval import OCRVerifier as JVerifier
from diffute_tpu.eval import psnr as j_psnr
from diffute_tpu.eval import run as jrun
from diffute_tpu.eval import ssim as j_ssim
from diffute_tpu.io import hostops as jhostops
from diffute_tpu.models import trocr_decoder as jdec
from diffute_tpu.pipeline import DiffUTEPipeline as JPipeline
from diffute_tpu.text import render_glyph

from diffute_tpu_torch.compat import trocr_decoder_state_dict, trocr_state_dict
from diffute_tpu_torch.config import tiny_test_config
from diffute_tpu_torch.eval import OCRVerifier, psnr, run, ssim
from diffute_tpu_torch.models.trocr_decoder import TrOCRDecoderConfig
from diffute_tpu_torch.pipeline import DiffUTEPipeline
from diffute_tpu_torch.text import CharTokenizer

# pytest puts tests/ itself on sys.path (conftest.py, prepend import mode)
from test_torch_port_acceptance import export_jax_layout, feed_jax_draws, rbg

# the decoder of eval --tiny
DEC = dict(vocab_size=64, hidden_size=16, decoder_layers=1,
           decoder_attention_heads=2, decoder_ffn_dim=32,
           max_position_embeddings=64)


def _varied_decoder(seed=4):
    """JAX params of eval --tiny's decoder whose greedy reads vary."""
    jcfg = jdec.TrOCRDecoderConfig(**DEC)
    p = jax.device_get(jdec.TrOCRDecoder(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2), jnp.int32),
        jnp.zeros((1, j_tiny().trocr.seq_len, 16)))["params"])
    p = jax.tree_util.tree_map(lambda a: a * 2 if a.ndim == 2 else a, p)
    p["embed_positions"] = p["embed_positions"] * 25
    return jcfg, p


def _crops():
    rs = np.random.RandomState(0)
    noise = [rs.randint(0, 256, (20 + 5 * i, 40 + 7 * i, 3)).astype(np.uint8)
             for i in range(4)]
    glyphs = [render_glyph(w, j_tiny().glyph) for w in ("AB", "hello", "42.00")]
    return noise + glyphs


def test_quality_metrics_equal_jax():
    rs = np.random.RandomState(1)
    a = rs.randint(0, 256, (40, 56, 3)).astype(np.uint8)
    b = np.clip(a.astype(np.int16) + rs.randint(-20, 21, a.shape), 0,
                255).astype(np.uint8)
    for x, y in ((a, b), (a, a), (a[..., 0], b[..., 0])):
        assert ssim(x, y) == j_ssim(x, y)
        assert psnr(x, y) == j_psnr(x, y)
    assert psnr(a, a) == math.inf
    with pytest.raises(ValueError, match="SSIM window"):
        ssim(a[:8, :8], b[:8, :8])


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """A JAX-exported tiny layout with the varied decoder as trocr_decoder/,
    and its JAX params."""
    path = str(tmp_path_factory.mktemp("eval") / "layout")
    params = export_jax_layout(path, j_tiny(), seed=5)
    _, dec = _varied_decoder()
    os.makedirs(os.path.join(path, "trocr_decoder"))
    j_save_safetensors(jdec.export_trocr_decoder_state_dict(dec),
                       os.path.join(path, "trocr_decoder", "model.safetensors"))
    return path, jax.device_get(params)


@pytest.mark.parametrize("use_cache", [True, False])
def test_verifier_reads_token_for_token(layout, use_cache):
    cfg = j_tiny()
    jcfg, jdec_params = _varied_decoder()
    enc = layout[1]["trocr"]
    tok = CharTokenizer()
    ref = JVerifier(cfg.trocr, jcfg, enc, jdec_params, tokenizer=tok,
                    max_len=8, use_cache=use_cache)
    mine = OCRVerifier(tiny_test_config().trocr, TrOCRDecoderConfig(**DEC),
                       trocr_state_dict(enc),
                       trocr_decoder_state_dict(jdec_params), tokenizer=tok,
                       max_len=8, use_cache=use_cache, device="cpu")
    crops = _crops()
    got, want = mine.read(crops), ref.read(crops)
    assert got.dtype == np.int32 and got.shape == (len(crops), 8)
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got}) >= 4  # the reads differ
    assert mine.read_text(crops) == list(ref.read_text(crops))
    assert mine.verify(crops[0], "x") == ref.verify(crops[0], "x")
    bare = OCRVerifier(tiny_test_config().trocr, TrOCRDecoderConfig(**DEC),
                       trocr_state_dict(enc),
                       trocr_decoder_state_dict(jdec_params), device="cpu")
    assert bare.verify(crops[0], "x") is None
    with pytest.raises(ValueError, match="tokenizer"):
        bare.read_text(crops)


def _capture_edits(monkeypatch, cls, store):
    real = cls.edit

    def edit(self, *a, **kw):
        out = real(self, *a, **kw)
        store.append((np.asarray(out[0]), np.asarray(out[2]["edited_crop"])))
        return out

    monkeypatch.setattr(cls, "edit", edit)


def _close(a, b, path):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        if math.isinf(a) or math.isinf(b):
            assert a == b, (path, a, b)
        else:
            assert abs(a - b) <= 1e-3 * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


@pytest.mark.parametrize("extra", [
    [], ["--cross_text", "--tokenizer", "char"],
    ["--cross_text_novel", "--tokenizer", "char"]],
    ids=["plain", "cross_text_char", "cross_text_novel_char"])
def test_eval_cli_report_matches_jax(layout, tmp_path, monkeypatch, extra):
    # JAX's uint8 resize on its native route: the port's arithmetic
    monkeypatch.setattr(jhostops, "cv2", None)
    argv = ["--tiny", "--synthetic", "2", "--steps", "2", "--pretrained",
            layout[0], *extra]
    j_edits, t_edits = [], []
    _capture_edits(monkeypatch, JPipeline, j_edits)
    _capture_edits(monkeypatch, DiffUTEPipeline, t_edits)
    with rbg():
        want = jrun.main(argv + ["--out", str(tmp_path / "jax.json")])
    feed_jax_draws(monkeypatch, j_tiny())
    got = run.main(argv + ["--device", "cpu", "--out",
                           str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert len(j_edits) == len(t_edits) == 2
    for (j_img, j_crop), (t_img, t_crop) in zip(j_edits, t_edits):
        for a, b in ((t_img, j_img), (t_crop, j_crop)):
            assert a.shape == b.shape
            assert np.abs(a.astype(np.int16) - b).max() <= 1
    _close(json.loads(json.dumps(got)), json.loads(json.dumps(want)), "report")
    assert got["num_examples"] == 2 and got["ssim_background_mean"] == 1.0
    if "--tokenizer" in extra:
        assert "ocr_text_match_rate" in got and got["ocr_mode"] == "tokenizer"
        assert any(r["ocr_text"] for r in got["examples"])  # non-empty reads
