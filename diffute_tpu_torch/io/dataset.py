"""Synthetic training data and the prefetching batch loader (numpy, host).

Counterpart of ``diffute_tpu/io/dataset.py`` for what stage-2 training on
synthetic scenes needs: ``SyntheticSceneDataset``, ``make_unet_batch`` and
``PrefetchLoader``, with the port's own host modules underneath.  Examples
are uint8 and are normalised on the device by the train step.  The manifest
datasets are not ported yet.
"""

from __future__ import annotations

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
from diffute_tpu_torch.text import render_glyph, trocr_preprocess_host


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

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        h, w = self.image_hw
        rng = np.random.default_rng(index)
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

        mask = generate_mask((h, w), box)
        masked = make_masked_image(image, mask)
        crop = train_crop(image, mask, masked, box, text, rng,
                          crop_scale=cfg.edit.train_crop_scale)
        res = cfg.edit.resolution
        return {
            "pixel_values": hostops.resize_bilinear_u8(crop.image, res, res),
            "masks": hostops.resize_bilinear_u8(crop.mask, res, res),
            "masked_images": hostops.resize_bilinear_u8(crop.masked_image,
                                                        res, res),
            # condition on the (possibly truncated) visible text
            "glyph_image": render_glyph(crop.text, cfg.glyph),
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
