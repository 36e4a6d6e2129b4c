"""Tokenization — an own copy of ``ctpa/data/tokenizer.py`` (the port imports
nothing of ``ctpa``): ``HFTokenizer`` wraps a local ``transformers``
tokenizer snapshot (CXR-BERT in production); ``SimpleWordTokenizer`` is the
self-contained tokenizer for tests and offline smoke runs."""

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


class HFTokenizer:
    """Thin wrapper over a local ``transformers`` tokenizer snapshot, exposing
    the call contract of ``SimpleWordTokenizer`` (numpy arrays, fixed
    max_length padding).  ``transformers`` is imported here, not with the
    module: a machine without it (the card's) raises ImportError naming it,
    and nothing falls back to another tokenizer."""

    def __init__(self, path_or_name: str, max_length: int = 512):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(f"HFTokenizer({path_or_name!r}) needs the `transformers` "
                              f"package, which is not installed") from e

        self.tok = AutoTokenizer.from_pretrained(path_or_name)
        self.max_length = max_length
        self.pad_token_id = self.tok.pad_token_id or 0
        self.cls_token_id = getattr(self.tok, "cls_token_id", None)
        self.sep_token_id = getattr(self.tok, "sep_token_id", None)
        self.eos_token_id = getattr(self.tok, "eos_token_id", None)

    def __call__(self, texts, max_length=None, padding="max_length"):
        out = self.tok(
            list(texts) if not isinstance(texts, str) else [texts],
            padding=padding, truncation=True,
            max_length=max_length or self.max_length,
            return_tensors="np",
        )
        return {"input_ids": out["input_ids"].astype(np.int32),
                "attention_mask": out["attention_mask"].astype(np.int32)}

    def decode(self, ids):
        return self.tok.decode([i for i in ids if i != self.pad_token_id],
                               skip_special_tokens=True)
