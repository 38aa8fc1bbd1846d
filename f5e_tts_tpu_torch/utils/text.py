"""Tokenizers (counterpart of part of `f5e_tts_tpu/utils/text.py`).

The "custom" (vocab file) and "byte" tokenizers are ported. The pinyin and
g2p tokenizers need jieba/pypinyin/g2p_mix and are not ported yet.
(reference: src/f5_tts/model/utils.py:80-170)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def load_vocab_file(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line[:-1]] = i
    return vocab


def get_tokenizer(dataset_name: str, tokenizer: str = "custom") -> Tuple[Optional[Dict[str, int]], int]:
    """(vocab_char_map, vocab_size): "custom" reads the vocab file at
    `dataset_name`; "byte" is UTF-8 with no map and size 256."""
    if tokenizer == "byte":
        return None, 256
    if tokenizer == "custom":
        vocab = load_vocab_file(dataset_name)
        return vocab, len(vocab)
    raise NotImplementedError(f"tokenizer {tokenizer!r} is not ported yet (custom and byte are)")


def list_str_to_idx(texts: Sequence[Sequence[str]], vocab: Dict[str, int],
                    padding_value: int = -1) -> np.ndarray:
    """Char/phone sequences -> (B, NT) int32 ids padded with -1; unknown -> 0."""
    rows = [[vocab.get(c, 0) for c in t] for t in texts]
    out = np.full((len(rows), max((len(r) for r in rows), default=0)), padding_value, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def list_str_to_bytes(texts: Sequence[str], padding_value: int = -1) -> np.ndarray:
    """UTF-8 byte tokenizer -> (B, NT) int32 padded with -1."""
    rows = [list(t.encode("utf-8")) for t in texts]
    out = np.full((len(rows), max((len(r) for r in rows), default=0)), padding_value, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out
