"""PyTorch port, the OCR verifier's training stage against the JAX
package's, at tiny width on the CPU.

- ``CharTokenizer``: the same ids and strings, printable and non-ASCII.
- ``SyntheticGlyphOCRDataset`` examples and ``make_ocr_batch`` byte for
  byte at the same (seed, index); JAX's uint8 resize is held on its native
  route, the port's arithmetic (its cv2 route is within 1 LSB on upscales,
  tests/test_hostops.py).
- ``OCRTrainer`` steps against ``make_ocr_train_step`` from the same params
  (through the bridge) and batches: loss, token accuracy and pre-clip
  gradient norm at rtol 1e-5, and every parameter after 3 AdamW steps.
- N + M steps equal a save, a restore and M steps, every bit.
- ``run_ocr --smoke --device cpu``: its ``trocr/`` and ``trocr_decoder/``
  export, read by JAX's importers, gives the trainer's final params.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffute_tpu.compat.hf_import import import_trocr_state_dict as j_import_vit
from diffute_tpu.compat.hf_import import load_safetensors as j_load_safetensors
from diffute_tpu.config import tiny_test_config as j_tiny
from diffute_tpu.io import dataset as jdataset
from diffute_tpu.io import hostops as jhostops
from diffute_tpu.models import trocr_decoder as jdec
from diffute_tpu.text.char_tokenizer import CharTokenizer as JTokenizer
from diffute_tpu.train.ocr_train import make_ocr_train_step
from diffute_tpu.train.optim import build_optimizer as j_build_optimizer
from diffute_tpu.train.state import TrainState as JTrainState
from diffute_tpu.utils.params import init_trocr_params

from diffute_tpu_torch.compat import trocr_decoder_state_dict, trocr_state_dict
from diffute_tpu_torch.config import tiny_test_config
from diffute_tpu_torch.io import dataset
from diffute_tpu_torch.models.trocr_decoder import TrOCRDecoderConfig
from diffute_tpu_torch.text import CharTokenizer, trocr_normalize
from diffute_tpu_torch.text.char_tokenizer import VOCAB_SIZE
from diffute_tpu_torch.train import OCRTrainer, run_ocr
from diffute_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from diffute_tpu_torch.train.ocr_train import split_params
from port_threads import torch_threads_per_worker  # noqa: F401

# run_ocr --smoke's decoder
DEC = dict(vocab_size=VOCAB_SIZE, hidden_size=16, decoder_layers=1,
           decoder_attention_heads=2, decoder_ffn_dim=32,
           max_position_embeddings=64)
BATCH, MAX_LEN, TOTAL = 4, 8, 10


def test_tokenizer_equals_jax():
    mine, ref = CharTokenizer(), JTokenizer()
    assert (mine.vocab_size, mine.bos_token_id, mine.pad_token_id,
            mine.eos_token_id) == (128, 0, 1, 2)
    texts = ["Hello 42!", "~ {x} |", "", "héllo wörld €5", "tab\there",
             "a" * 40, "日本語 ok"]
    for max_len in (4, 16, 64):
        for t in texts:
            a, b = mine.encode(t, max_len), ref.encode(t, max_len)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
            assert mine.decode(a) == ref.decode(b)
            assert (mine.decode(a, skip_special_tokens=False)
                    == ref.decode(b, skip_special_tokens=False))
    ids = np.stack([mine.encode(t, 16) for t in texts])
    ids[0, -1] = 0  # a BOS after the PADs
    assert mine.batch_decode(ids) == ref.batch_decode(ids)
    assert mine.batch_decode(ids, False) == ref.batch_decode(ids, False)


def test_glyph_ocr_dataset_bytes_equal_jax(monkeypatch):
    monkeypatch.setattr(jhostops, "cv2", None)
    for seed, max_len in ((0, 16), (3, 10)):
        mine = dataset.SyntheticGlyphOCRDataset(tiny_test_config(), seed=seed,
                                                max_len=max_len)
        ref = jdataset.SyntheticGlyphOCRDataset(j_tiny(), seed=seed,
                                                max_len=max_len)
        assert len(mine) == len(ref)
        items = [(mine[i], ref[i]) for i in range(24)]
        for a, b in items:
            assert set(a) == set(b) == {"glyph_image", "target_ids"}
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
        # both kinds occur: plain canvases (60 px tall) and region-style
        # crops (rescaled, with the 10% extension: other heights)
        heights = {a["glyph_image"].shape[0] for a, _ in items}
        assert 60 in heights and len(heights) > 2
        got = dataset.make_ocr_batch([a for a, _ in items[:6]],
                                     tiny_test_config())
        want = jdataset.make_ocr_batch([b for _, b in items[:6]], j_tiny())
        assert got["glyph_pixels"].shape == (6, 32, 32, 3)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def jparams():
    cfg = j_tiny()
    jcfg = jdec.TrOCRDecoderConfig(**DEC)
    enc = jax.device_get(init_trocr_params(cfg, jax.random.PRNGKey(0)))
    dec = jax.device_get(jdec.TrOCRDecoder(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 2), jnp.int32),
        jnp.zeros((1, cfg.trocr.seq_len, 16)))["params"])
    return {"encoder": enc, "decoder": dec}


def _configs(lr=1e-3):
    out = []
    for cfg in (j_tiny(), tiny_test_config()):
        opt = dataclasses.replace(cfg.train.optimizer, learning_rate=lr,
                                  lr_scheduler="constant")
        out.append(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, train_batch_size=BATCH, optimizer=opt)))
    return out


def _batches(n, seed=0):
    ds = dataset.SyntheticGlyphOCRDataset(tiny_test_config(), seed=seed,
                                          max_len=MAX_LEN)
    return [dataset.make_ocr_batch([ds[BATCH * i + j] for j in range(BATCH)],
                                   tiny_test_config()) for i in range(n)]


def _bridged(jp):
    return {"encoder": trocr_state_dict(jp["encoder"]),
            "decoder": trocr_decoder_state_dict(jp["decoder"])}


def _trainer(tcfg, jp):
    return OCRTrainer(tcfg, TrOCRDecoderConfig(**DEC), _bridged(jp),
                      device="cpu", total_steps=TOTAL)


def test_three_steps_match_jax(jparams):
    jcfg, tcfg = _configs()
    tx = j_build_optimizer(jcfg.train.optimizer, TOTAL, BATCH)
    state = JTrainState.create(jparams, tx)
    j_step = jax.jit(make_ocr_train_step(jcfg, jdec.TrOCRDecoderConfig(**DEC),
                                         tx))
    trainer = _trainer(tcfg, jparams)
    batches = _batches(3)
    # first targets the untrained reader already gets right, so that the
    # token accuracy is not 0 on both sides
    with torch.no_grad():
        m = trainer.model
        enc = m.encoder(trocr_normalize(torch.from_numpy(
            batches[0]["glyph_pixels"])).permute(0, 3, 1, 2))
        start = torch.full((BATCH, 1), m.decoder.config.decoder_start_token_id)
        batches[0]["target_ids"][:, 0] = (
            m.decoder(start, enc)[:, 0].argmax(-1).numpy())
    for i, batch in enumerate(batches):
        state, want = j_step(state, None, batch, None)
        got = trainer.step(batch)
        # fp32 on both sides, other summation orders: the loss and the
        # gradient norm agreed to 2.5e-7 relative when this was written
        for k in ("loss", "token_accuracy", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=k)
        if i == 0:
            assert float(got["token_accuracy"]) > 0
    assert trainer.state.step == int(state.step) == 3
    ref = _bridged(jax.device_get(state.params))
    mine = {p: {k: v.detach() for k, v in sd.items()}
            for p, sd in split_params(trainer.state.params_dict()).items()}
    assert {p: set(sd) for p, sd in mine.items()} == {
        p: set(sd) for p, sd in ref.items()}
    # AdamW moves a weight by lr * g / (|g| + eps), lr = 1e-3: where |g| is
    # at the noise floor the last bits of g decide the step, which then
    # differs by up to 2 lr.  The key biases are all there (their gradient
    # is 0 up to rounding: the softmax ignores a shift shared by all keys);
    # elsewhere a handful of weights.  Measured after 3 steps: key biases
    # 6.6e-5 at most (56 of 64 above 1e-6); the other 23,296 weights
    # 3.3e-5 at most, 3 of them above 1e-6.
    errs = {f"{p}.{k}": (mine[p][k] - ref[p][k]).abs().flatten()
            for p in ref for k in ref[p]}
    key_bias = ("key.bias", "k_proj.bias")
    rest = torch.cat([e for k, e in errs.items() if not k.endswith(key_bias)])
    assert max(float(e.max()) for e in errs.values()) <= 6e-3  # 2 lr a step
    assert float(rest.max()) <= 1e-3
    assert int((rest > 1e-6).sum()) <= 1e-3 * rest.numel()


def test_save_restore_resumes_bit_for_bit(jparams, tmp_path):
    _, tcfg = _configs()
    batches = _batches(5, seed=1)
    straight = _trainer(tcfg, jparams)
    for b in batches:
        straight.step(b)
    first = _trainer(tcfg, jparams)
    for b in batches[:3]:
        first.step(b)
    path = save_checkpoint(str(tmp_path), 3, first.state_dict())
    resumed = _trainer(tcfg, jparams)
    resumed.load_state_dict(restore_checkpoint(path))
    assert resumed.state.step == 3
    for b in batches[3:]:
        resumed.step(b)
    a, b = straight.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 5
    assert a["opt"]["count"] == b["opt"]["count"] == 5
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for m in ("mu", "nu"):
        for k in a["opt"][m]:
            assert torch.equal(a["opt"][m][k], b["opt"][m][k]), (m, k)


def test_run_ocr_smoke_export_reads_in_jax(tmp_path):
    out = tmp_path / "ocr"
    history = run_ocr.main(["--smoke", "--device", "cpu", "--output_dir",
                            str(out), "--report_to", "none",
                            "--max_train_steps", "3",
                            "--checkpointing_steps", "2",
                            "--dataloader_num_workers", "1"])
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and 0 <= h["token_accuracy"] <= 1
               for h in history)
    ckpt = out / "checkpoint-3"
    assert sorted(os.listdir(ckpt)) == ["state", "trocr", "trocr_decoder"]
    with open(ckpt / "trocr_decoder" / "config.json") as f:
        dcfg = json.load(f)
    assert dcfg == {"model_type": "trocr", "tokenizer": "char", **DEC}
    state = restore_checkpoint(str(ckpt))
    enc = j_import_vit(j_load_safetensors(str(ckpt / "trocr" /
                                              "model.safetensors")))
    dec = jdec.import_trocr_decoder_state_dict(j_load_safetensors(
        str(ckpt / "trocr_decoder" / "model.safetensors")))
    # JAX's importers give trees of the JAX models' structure ...
    ref = {"encoder": jax.device_get(init_trocr_params(
        j_tiny(), jax.random.PRNGKey(0))),
        "decoder": jax.device_get(jdec.TrOCRDecoder(
            jdec.TrOCRDecoderConfig(**DEC)).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 2), jnp.int32),
            jnp.zeros((1, 5, 16)))["params"])}
    for part, tree in (("encoder", enc), ("decoder", dec)):
        assert (jax.tree_util.tree_structure(tree)
                == jax.tree_util.tree_structure(ref[part]))
    # ... holding the trainer's final params, bit for bit
    mine = _bridged({"encoder": enc, "decoder": dec})
    for part in mine:
        for k, v in mine[part].items():
            assert torch.equal(v, state["params"][f"{part}.{k}"]), (part, k)
    # a resume at the budget trains nothing; the step counts persist
    assert run_ocr.main(["--smoke", "--device", "cpu", "--output_dir",
                         str(out), "--report_to", "none",
                         "--max_train_steps", "3",
                         "--resume_from_checkpoint", "latest"]) == []
    with pytest.raises(NotImplementedError, match="steps_per_call"):
        run_ocr.main(["--smoke", "--device", "cpu", "--steps_per_call", "2"])
