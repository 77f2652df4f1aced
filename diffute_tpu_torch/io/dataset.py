"""Training datasets and the prefetching batch loader (numpy, host).

Counterpart of ``diffute_tpu/io/dataset.py`` with the port's own host
modules underneath:

- ``UNetManifestDataset`` (stage 2): a CSV with ``image_path`` /
  ``ocr_path`` columns and OCR JSON files shaped ``{"document": [{"text",
  "box": [[x, y] x 4], "score"}]}``; regions with score above the
  threshold, one sampled per (seed, index), cropped by the training policy
  and resized to the edit resolution, with the glyph render of its text.
- ``VAEManifestDataset`` (stage 1): a CSV with a ``path`` column; a short
  side under the resolution is upscaled by ``int(2 * res / short)``, then a
  random res^2 crop.
- ``SyntheticSceneDataset``: procedural document-like pages with rendered
  text, so trainers run without external data.
- ``SyntheticGlyphOCRDataset``: degraded glyph renders and their character
  ids, the OCR verifier's training data.

Manifests are read with the stdlib ``csv`` module (the JAX package uses
pandas; the rows are the same).  Blobs come through ``io.storage`` (local,
``file://``, registered schemes such as ``oss://``).  Examples are uint8
and are normalised on the device by the train step.  A failing example (a
corrupt blob) is replaced by a deterministic alternate index, never
dropped.
"""

from __future__ import annotations

import csv
import io
import json
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from diffute_tpu_torch.config import DiffUTEConfig
from diffute_tpu_torch.io import hostops
from diffute_tpu_torch.pipeline.crop import train_crop
from diffute_tpu_torch.pipeline.regions import (
    generate_mask,
    make_masked_image,
    process_location,
)
from diffute_tpu_torch.io.storage import open_blob, read_image
from diffute_tpu_torch.text import (CharTokenizer, render_glyph,
                                    trocr_preprocess_host)


def read_manifest(path: str) -> Dict[str, List[str]]:
    """A manifest CSV's columns (header row first), as ``pd.read_csv``
    reads them for path columns: blank lines skipped, a UTF-8 BOM ignored,
    cells kept as written."""
    with open_blob(path) as f:
        text = f.read().decode("utf-8-sig")
    rows = [r for r in csv.reader(io.StringIO(text)) if r]
    header, body = rows[0], rows[1:]
    return {name: [r[i] if i < len(r) else "" for r in body]
            for i, name in enumerate(header)}


def _resize(img: np.ndarray, res: int) -> np.ndarray:
    return hostops.resize_bilinear_u8(img, res, res)


class UNetManifestDataset:
    """Stage-2 examples: one OCR region per image, per (seed, index)."""

    def __init__(self, manifest_csv: str, config: DiffUTEConfig,
                 seed: int = 0, bgr: bool = False):
        cols = read_manifest(manifest_csv)
        self.image_paths: List[str] = cols["image_path"]
        self.ocr_paths: List[str] = cols["ocr_path"]
        self.config = config
        self.seed = seed
        self.bgr = bgr

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        # a generator per call: thread-safe under the loader and
        # reproducible per (seed, index)
        rng = np.random.default_rng((self.seed, index))
        image = read_image(self.image_paths[index], bgr=self.bgr)
        with open_blob(self.ocr_paths[index]) as f:
            ocr = json.loads(f.read())
        regions = [r for r in ocr["document"]
                   if r.get("score", 1.0) > cfg.train.ocr_score_threshold]
        if not regions:
            raise ValueError(f"No OCR region above threshold: "
                             f"{self.ocr_paths[index]}")
        region = regions[int(rng.integers(len(regions)))]
        quad = np.asarray(region["box"], dtype=np.float32)
        box = np.int32([quad[:, 0].min(), quad[:, 1].min(),
                        quad[:, 0].max(), quad[:, 1].max()])
        h, w = image.shape[:2]
        box = process_location(box, (h, w))

        mask = generate_mask((h, w), box)
        masked = make_masked_image(image, mask)
        crop = train_crop(image, mask, masked, box, region["text"], rng,
                          crop_scale=cfg.edit.train_crop_scale)
        res = cfg.edit.resolution
        return {
            "pixel_values": _resize(crop.image, res),
            "masks": _resize(crop.mask, res),
            "masked_images": _resize(crop.masked_image, res),
            "glyph_image": render_glyph(crop.text, cfg.glyph),
        }


class VAEManifestDataset:
    """Stage-1 examples: random res^2 crops of document pages."""

    def __init__(self, manifest_csv: str, config: DiffUTEConfig,
                 seed: int = 0, bgr: bool = False, path_column: str = "path"):
        self.paths: List[str] = read_manifest(manifest_csv)[path_column]
        self.config = config
        self.seed = seed
        self.bgr = bgr

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        res = self.config.edit.resolution
        rng = np.random.default_rng((self.seed, index))
        image = read_image(self.paths[index], bgr=self.bgr)
        h, w = image.shape[:2]
        short = min(h, w)
        if short < res:
            # the reference's int(1024 / short) upscale at 512
            scale = int(res * 2 / short)
            image = hostops.resize_bilinear_u8(image, h * scale, w * scale)
            h, w = image.shape[:2]
        y = int(rng.integers(0, h - res + 1))
        x = int(rng.integers(0, w - res + 1))
        return {"pixel_values": image[y : y + res, x : x + res]}


class SyntheticSceneDataset:
    """Procedural text-on-background images with their OCR boxes: one
    rendered word pasted on a flat light page, cropped by the training
    policy.  Examples are deterministic per index."""

    # all words <= 10 chars, so the full box fits a 256-px crop at a text
    # height the VAE keeps readable
    _WORDS = ("INVOICE", "TOTAL", "2023-08-16", "Amount", "Reference",
              "DiffUTE", "TPU", "hello", "42.00", "Document")
    # printable ASCII only, so a character tokenizer covers every target
    _CHARSET = ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                "abcdefghijklmnopqrstuvwxyz0123456789.-")

    def __init__(self, config: DiffUTEConfig, image_hw=(384, 512),
                 seed: int = 0, vocab: str = "fixed"):
        """``vocab``: "fixed" = the 10-word list; "random" = every example a
        fresh 3-10 character string; "mixed" = 50/50."""
        if vocab not in ("fixed", "mixed", "random"):
            raise ValueError(f"vocab must be fixed|mixed|random, got {vocab!r}")
        self.config = config
        self.image_hw = image_hw
        self.seed = seed
        self.vocab = vocab

    def _sample_text(self, rng) -> str:
        # the extra draws are gated, so the "fixed" stream does not depend
        # on the vocabulary option
        if self.vocab != "fixed" and (self.vocab == "random"
                                      or rng.random() < 0.5):
            n = int(rng.integers(3, 11))
            idx = rng.integers(len(self._CHARSET), size=n)
            return "".join(self._CHARSET[int(c)] for c in idx)
        return self._WORDS[int(rng.integers(len(self._WORDS)))]

    def __len__(self) -> int:
        return 1 << 30

    def page(self, index: int, rng: Optional[np.random.Generator] = None):
        """The uncropped page of example ``index``: (image (H, W, 3) uint8,
        box (x1, y1, x2, y2), text).  ``rng``: the example's generator, at
        its start (made from ``index`` when None)."""
        cfg = self.config
        h, w = self.image_hw
        rng = np.random.default_rng(index) if rng is None else rng
        image = np.full((h, w, 3), int(rng.integers(180, 255)), np.uint8)
        text = self._sample_text(rng)
        glyph = render_glyph(text, cfg.glyph)
        gh, gw = glyph.shape[:2]
        # text tall enough for its strokes to survive the VAE, capped so the
        # full box fits an inference crop window
        fit = min(1.0, (min(h, w) - 24) / gw)
        scale = fit * float(rng.uniform(0.55, 1.0))
        gw2, gh2 = max(8, int(gw * scale)), max(8, int(gh * scale))
        glyph_s = hostops.resize_bilinear_u8(glyph, gh2, gw2)
        y = int(rng.integers(0, h - gh2))
        x = int(rng.integers(0, w - gw2))
        region = image[y : y + gh2, x : x + gw2]
        image[y : y + gh2, x : x + gw2] = np.minimum(region, glyph_s)
        box = process_location(np.int32([x, y, x + gw2, y + gh2]), (h, w))
        return image, box, text

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        rng = np.random.default_rng(index)
        image, box, text = self.page(index, rng)
        h, w = image.shape[:2]
        mask = generate_mask((h, w), box)
        masked = make_masked_image(image, mask)
        crop = train_crop(image, mask, masked, box, text, rng,
                          crop_scale=cfg.edit.train_crop_scale)
        res = cfg.edit.resolution
        return {
            "pixel_values": _resize(crop.image, res),
            "masks": _resize(crop.mask, res),
            "masked_images": _resize(crop.masked_image, res),
            # condition on the (possibly truncated) visible text
            "glyph_image": render_glyph(crop.text, cfg.glyph),
        }


class SyntheticGlyphOCRDataset:
    """Glyph render -> character-id pairs for training the OCR verifier.

    Half the examples are raw glyph canvases (what the conditioning branch
    sees), half region-style crops: the glyph rescaled onto a light
    background with the +10%-height bottom extension of eval's box crop.
    Each then goes through, with probability 1/2 each, a down-up resize
    blur, Gaussian noise and an ink-contrast fade, so the verifier reads
    text that came through a VAE decode and a sampler.  Deterministic per
    (seed, index)."""

    def __init__(self, config: DiffUTEConfig, seed: int = 0,
                 max_len: int = 16, words=SyntheticSceneDataset._WORDS):
        self.config = config
        self.seed = seed
        self.max_len = max_len
        self.words = words
        self.tokenizer = CharTokenizer()
        # sampling alphabet of the random strings (the tokenizer covers all
        # printable ASCII)
        self._alphabet = ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                          "abcdefghijklmnopqrstuvwxyz0123456789.,-:/% ")

    def __len__(self) -> int:
        return 1 << 30

    def _sample_text(self, rng) -> str:
        if rng.random() < 0.4:
            return self.words[int(rng.integers(len(self.words)))]
        n = int(rng.integers(1, self.max_len - 2))
        s = "".join(self._alphabet[int(i)]
                    for i in rng.integers(len(self._alphabet), size=n))
        return s.strip() or "x"

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        rng = np.random.default_rng((self.seed, index))
        text = self._sample_text(rng)
        glyph = render_glyph(text, cfg.glyph)
        if rng.random() < 0.5:
            # region-style: the rescaled glyph on a light background with
            # the +10%-height bottom extension
            gh, gw = glyph.shape[:2]
            s = float(rng.uniform(0.3, 1.0))
            gh2, gw2 = max(8, int(gh * s)), max(8, int(gw * s))
            scaled = hostops.resize_bilinear_u8(glyph, gh2, gw2)
            bg = int(rng.integers(180, 255))
            region = np.full((gh2 + max(1, gh2 // 10), gw2, 3), bg, np.uint8)
            region[:gh2] = np.minimum(region[:gh2], scaled)
            glyph = region
        if rng.random() < 0.5:  # blur: down and up again
            h0, w0 = glyph.shape[:2]
            f = float(rng.uniform(0.45, 0.85))
            small = hostops.resize_bilinear_u8(
                glyph, max(4, int(h0 * f)), max(4, int(w0 * f)))
            glyph = hostops.resize_bilinear_u8(small, h0, w0)
        if rng.random() < 0.5:  # residual noise
            noise = rng.normal(0.0, float(rng.uniform(2.0, 12.0)),
                               glyph.shape)
            glyph = np.clip(glyph.astype(np.float32) + noise,
                            0, 255).astype(np.uint8)
        if rng.random() < 0.5:
            # ink-contrast fade toward the local white point
            c = float(rng.uniform(0.35, 1.0))
            white = float(glyph.max())
            glyph = np.clip(white - (white - glyph.astype(np.float32)) * c,
                            0, 255).astype(np.uint8)
        return {"glyph_image": glyph,
                "target_ids": self.tokenizer.encode(text, self.max_len)}


def make_ocr_batch(examples: List[Dict[str, np.ndarray]],
                   config: DiffUTEConfig) -> Dict[str, np.ndarray]:
    """glyph_pixels (B, S, S, 3) uint8 and target_ids (B, max_len) int32."""
    return {
        "glyph_pixels": trocr_preprocess_host(
            [e["glyph_image"] for e in examples], config.trocr),
        "target_ids": np.stack([e["target_ids"] for e in examples]),
    }


def make_unet_batch(examples: List[Dict[str, np.ndarray]],
                    config: DiffUTEConfig) -> Dict[str, np.ndarray]:
    """Stack examples into the train step's batch layout; the variable-width
    glyph renders go through the TrOCR host preprocessing here."""
    return {
        "pixel_values": np.stack([e["pixel_values"] for e in examples]),
        "masks": np.stack([e["masks"] for e in examples]),
        "masked_images": np.stack([e["masked_images"] for e in examples]),
        "glyph_pixels": trocr_preprocess_host(
            [e["glyph_image"] for e in examples], config.trocr),
    }


def make_vae_batch(examples: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    return {"pixel_values": np.stack([e["pixel_values"] for e in examples])}


# Epoch-shuffle permutations above this dataset size would cost GBs of host
# memory; such datasets (the 2^30-example synthetic stream) are sampled with
# replacement instead, which is statistically equivalent there.
_EPOCH_SHUFFLE_MAX = 1 << 24

# Substitution attempts per failing example before the data source is
# declared broken.
_EXAMPLE_RETRIES = 8


class PrefetchLoader:
    """Thread-pool batch producer overlapping host decode with device steps.

    ``shuffle``: ``"epoch"`` = a fresh shuffled permutation per epoch, every
    index once, the trailing partial batch dropped (``num_epochs`` bounds
    iteration, ``start_epoch`` supports resume); ``"replacement"`` = infinite
    i.i.d. sampling; ``None`` = "epoch" for real datasets, "replacement" for
    datasets too large to permute.  With ``process_count > 1`` each process
    draws a disjoint interleaved shard of every epoch permutation.
    """

    def __init__(self, dataset, batch_size: int, collate, num_threads: int = 4,
                 prefetch: int = 4, seed: int = 0,
                 shuffle: Optional[str] = None,
                 num_epochs: Optional[int] = None, start_epoch: int = 0,
                 process_index: int = 0, process_count: int = 1):
        shuffle = self.resolve_shuffle(len(dataset), batch_size,
                                       process_count, shuffle)
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.seed = seed
        self.shuffle = shuffle
        self.num_epochs = num_epochs
        self.start_epoch = start_epoch
        self.process_index = process_index
        self.process_count = process_count

    @staticmethod
    def resolve_shuffle(n: int, batch_size: int, process_count: int = 1,
                        shuffle: Optional[str] = None) -> str:
        """The sampling mode ``shuffle=None`` resolves to."""
        if shuffle not in (None, "epoch", "replacement"):
            raise ValueError(f"shuffle must be 'epoch'/'replacement'/None, "
                             f"got {shuffle!r}")
        too_small = n // process_count < batch_size
        if shuffle is None:
            return ("replacement" if n >= _EPOCH_SHUFFLE_MAX or too_small
                    else "epoch")
        if shuffle == "epoch" and too_small:
            raise ValueError(
                f"epoch shuffle needs >= one batch per process: "
                f"{n} examples / {process_count} processes < "
                f"batch_size {batch_size}")
        return shuffle

    @property
    def steps_per_epoch(self) -> int:
        """Full batches per epoch on this process (epoch mode)."""
        return (len(self.dataset) // self.process_count) // self.batch_size

    def _index_batches(self) -> Iterator[List[int]]:
        n = len(self.dataset)
        if self.shuffle == "replacement":
            rng = np.random.default_rng((self.seed, self.process_index))
            while True:
                yield [int(rng.integers(n)) for _ in range(self.batch_size)]
        else:
            epoch = self.start_epoch
            while self.num_epochs is None or epoch < self.num_epochs:
                # seeded by (seed, epoch) only: all processes draw the same
                # permutation and slice disjoint interleaved shards of it
                perm = np.random.default_rng((self.seed, epoch)).permutation(n)
                shard = perm[self.process_index::self.process_count]
                for i in range(0, len(shard) - self.batch_size + 1,
                               self.batch_size):
                    yield [int(j) for j in shard[i : i + self.batch_size]]
                epoch += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        gen = self._index_batches()
        lock = threading.Lock()
        self.error_count = 0
        fatal = []  # non-example worker failure, re-raised in the consumer

        def put_stop_aware(item):
            while not stop.is_set():  # bounded put: notice consumer exit
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        n = len(self.dataset)

        def fetch(i):
            # a failing example is replaced by a deterministic alternate
            # index, never dropped, so every batch keeps its size
            for attempt in range(_EXAMPLE_RETRIES):
                j = i if attempt == 0 else (i + attempt * 104729) % n
                try:
                    return self.dataset[j]
                except Exception as e:
                    self.error_count += 1
                    if (self.error_count in (1, 10, 100)
                            or self.error_count % 1000 == 0):
                        print(f"[data] example {j} failed (error "
                              f"#{self.error_count}), substituting: "
                              f"{type(e).__name__}: {e}", flush=True)
            raise RuntimeError(
                f"{_EXAMPLE_RETRIES} consecutive example failures starting "
                f"at index {i}; data source looks broken")

        def worker():
            try:
                while not stop.is_set():
                    with lock:
                        idx = next(gen, None)
                    if idx is None:  # epoch budget exhausted
                        return
                    put_stop_aware(self.collate([fetch(i) for i in idx]))
            except BaseException as e:
                fatal.append(e)
            finally:
                put_stop_aware(None)  # always deliver the sentinel

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        finished = 0
        try:
            while finished < len(threads):
                item = q.get()
                if item is None:
                    finished += 1
                    continue
                yield item
            if fatal:
                raise fatal[0]
        finally:
            stop.set()
