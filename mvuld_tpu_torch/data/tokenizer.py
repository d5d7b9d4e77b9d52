"""Code tokenizer with UniXcoder framing semantics.

The reference tokenizes with HF ``RobertaTokenizer`` (byte-level BPE) plus an
added ``<mask0>`` special token, and frames encoder-only inputs as

    [<s>, <encoder-only>, </s>] + tokens[:max_len-4] + [</s>]

padding to ``max_len`` with pad id 1 (reference: mvuld/models/unixcoder.py:
119-152). This module reproduces that framing on top of the ``tokenizers``
library. Two construction paths:

  * ``CodeTokenizer.from_files(vocab.json, merges.txt)`` — exact parity with a
    released UniXcoder vocab (when the user supplies the files),
  * ``CodeTokenizer.train(corpus, vocab_size)`` — a self-contained byte-level
    BPE trained on the user's own corpus (no network access needed).
"""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence

import numpy as np

SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>",
            "<encoder-only>", "<decoder-only>", "<encoder-decoder>", "<mask0>"]
CLS, PAD, SEP, UNK = "<s>", "<pad>", "</s>", "<unk>"
MODES = ("<encoder-only>", "<decoder-only>", "<encoder-decoder>")


class CodeTokenizer:
    def __init__(self, tok):
        self._tok = tok
        self.cls_id = tok.token_to_id(CLS)
        self.pad_id = tok.token_to_id(PAD)
        self.sep_id = tok.token_to_id(SEP)
        self.mode_ids = {m: tok.token_to_id(m) for m in MODES}
        assert None not in (self.cls_id, self.pad_id, self.sep_id), "missing special tokens"

    # -- construction --------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "CodeTokenizer":
        from tokenizers import ByteLevelBPETokenizer
        tok = ByteLevelBPETokenizer(vocab_json, merges_txt)
        missing = [s for s in SPECIALS if tok.token_to_id(s) is None]
        if missing:
            tok.add_special_tokens(missing)
        return cls(tok)

    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int = 8192) -> "CodeTokenizer":
        from tokenizers import ByteLevelBPETokenizer
        tok = ByteLevelBPETokenizer()
        tok.train_from_iterator(iter(corpus), vocab_size=vocab_size,
                                special_tokens=SPECIALS, min_frequency=2)
        return cls(tok)

    @classmethod
    def load(cls, path: str) -> "CodeTokenizer":
        from tokenizers import Tokenizer
        t = cls.__new__(cls)
        CodeTokenizer.__init__(t, Tokenizer.from_file(path))
        return t

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._tok.save(path)

    # -- encoding -------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode_ids(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def tokenize(self, inputs: Sequence[str], mode: str = "<encoder-only>",
                 max_length: int = 512, padding: bool = True) -> np.ndarray:
        """UniXcoder framing (reference: unixcoder.py tokenize:119-152).

        Returns int32 [len(inputs), max_length] when padding else a ragged list.
        """
        assert mode in MODES
        mode_id = self.mode_ids[mode]
        rows = []
        for text in inputs:
            ids = self.encode_ids(text)
            if mode == "<encoder-only>":
                ids = [self.cls_id, mode_id, self.sep_id] + ids[: max_length - 4] + [self.sep_id]
            elif mode == "<decoder-only>":
                ids = [self.cls_id, mode_id, self.sep_id] + ids[-(max_length - 3):]
            else:
                ids = [self.cls_id, mode_id, self.sep_id] + ids[: max_length - 5] + [self.sep_id]
            if padding:
                ids = ids + [self.pad_id] * (max_length - len(ids))
            rows.append(ids)
        if padding:
            return np.asarray(rows, dtype=np.int32)
        return rows

    def decode(self, ids: Sequence[int]) -> str:
        ids = [int(i) for i in ids if int(i) != self.pad_id]
        return self._tok.decode(ids, skip_special_tokens=True)


def vocab_size_of(path: str) -> int:
    """``CodeTokenizer.load(path).vocab_size`` read from the saved JSON
    alone (model vocabulary and added tokens, counted once each), so a
    trainer can size its embedding where the ``tokenizers`` package is
    absent."""
    import json

    with open(path) as f:
        spec = json.load(f)
    vocab = dict(spec["model"]["vocab"])
    vocab.update({t["content"]: t["id"] for t in spec.get("added_tokens", [])})
    return len(vocab)


def normalize_line(text: str) -> str:
    """Whitespace-normalize a code line the way the reference does before
    per-node tokenization (``' '.join(node.split())``, unixcoder.py:62)."""
    return " ".join(text.split())
