"""Self-contained tokenizer for tests and offline smoke runs — an own copy of
``ctpa/data/tokenizer.py:SimpleWordTokenizer`` (the port imports nothing of
``ctpa``).  Production serving uses a real WordPiece tokenizer snapshot."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class SimpleWordTokenizer:
    """Hash-bucket tokenizer with BERT's special-token layout:
    [CLS] tok ... tok [SEP] pad...  (pad=0, cls=101, sep=102 like BERT).
    Word ids come from Python's ``hash``, so they are fixed within a process
    (and across processes only under a fixed PYTHONHASHSEED)."""

    pad_token_id = 0

    def __init__(self, vocab_size: int = 30522, max_length: int = 512):
        self.vocab_size = vocab_size
        self.max_length = max_length
        # compact special ids for tiny test vocabs keep hashed ids in range
        if vocab_size >= 1100:
            self.cls_token_id, self.sep_token_id, self._reserved = 101, 102, 999
        else:
            self.cls_token_id, self.sep_token_id, self._reserved = 1, 2, 4

    def _tok(self, word: str) -> int:
        return self._reserved + (hash(word) % (self.vocab_size - self._reserved))

    def __call__(self, texts: Sequence[str] | str, max_length: Optional[int] = None,
                 padding: str = "max_length") -> dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        rows = []
        for text in texts:
            toks = [self.cls_token_id] + [self._tok(w) for w in text.lower().split()]
            rows.append(toks[: L - 1] + [self.sep_token_id])
        if padding != "max_length":
            L = max(len(r) for r in rows)
        ids = np.zeros((len(texts), L), np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for i, toks in enumerate(rows):
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"<{i}>" for i in ids
                        if i not in (self.pad_token_id, self.cls_token_id, self.sep_token_id))
