"""Character-level tokenizer of the OCR verifier.

Counterpart of ``diffute_tpu/text/char_tokenizer.py``: printable ASCII
(space through tilde, 95 characters) at ids 3..97, with the TrOCR / BART
special ids bos 0, pad 1, eos 2, in a table padded to 128 ids.  The OCR
training stage (``train/run_ocr.py``) and the eval CLI's ``--tokenizer
char`` use it; it covers the slice of the HF tokenizer API that
:class:`diffute_tpu_torch.eval.OCRVerifier` touches (``batch_decode``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

CHARSET = "".join(chr(c) for c in range(32, 127))

BOS_ID = 0
PAD_ID = 1
EOS_ID = 2
_OFFSET = 3

# embedding-table size: 98 used ids padded up to 128
VOCAB_SIZE = 128


class CharTokenizer:
    """Printable-ASCII char <-> id mapping with BART-style specials."""

    vocab_size = VOCAB_SIZE
    bos_token_id = BOS_ID
    pad_token_id = PAD_ID
    eos_token_id = EOS_ID

    def __init__(self):
        self._to_id = {ch: i + _OFFSET for i, ch in enumerate(CHARSET)}
        self._to_ch = {i + _OFFSET: ch for i, ch in enumerate(CHARSET)}

    def encode(self, text: str, max_len: int) -> np.ndarray:
        """Text -> (max_len,) int32: chars + EOS, right-padded with PAD.
        Unknown characters are skipped; overlong text is truncated to leave
        room for the EOS."""
        ids = [self._to_id[c] for c in text if c in self._to_id]
        ids = ids[: max_len - 1] + [EOS_ID]
        ids += [PAD_ID] * (max_len - len(ids))
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == EOS_ID:
                break
            if i in self._to_ch:
                out.append(self._to_ch[i])
            elif not skip_special_tokens and i in (BOS_ID, PAD_ID):
                out.append("<s>" if i == BOS_ID else "<pad>")
        return "".join(out)

    def batch_decode(self, ids_batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(row, skip_special_tokens)
                for row in np.asarray(ids_batch)]
