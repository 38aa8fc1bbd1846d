"""Tokenizers and text helpers (counterpart of `f5e_tts_tpu/utils/text.py`).

Ported: the "char" and "custom" (vocab file) and "byte" tokenizers, the id mapping,
and the pure-Python helpers (`g2p_mix_vocab`, `split_rime`,
`g2p_mix_process_token`, `intersperse`, `split_pinyin`,
`repetition_found`). Not ported: the pinyin converters and the g2p-mix
phonemizer, which need pypinyin/g2p_mix; a tokenizer that needs them raises
NotImplementedError. (reference: src/f5_tts/model/utils.py:80-325,
model/dataset.py:141-164, durpred/utils.py:10-16)
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_vocab_file(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line[:-1]] = i
    return vocab


def g2p_mix_vocab() -> Dict[str, int]:
    """Phone inventory of the g2p-mix tokenizer; ids are positions: pad,
    Mandarin initials/finals, English ARPAbet, punctuation, toned Mandarin
    finals, stressed English vowels, digits (reference: utils.py:103-130)."""
    en_phones = [
        "AA", "AE", "AH", "AO", "AW", "AX", "AY", "B", "CH", "D", "DH", "EH", "ER",
        "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
        "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z", "ZH",
    ]
    zh_phones = [
        "a", "b", "c", "ch", "d", "e", "er", "f", "g", "h", "i", "j", "k", "l",
        "m", "n", "ng", "o", "p", "q", "r", "s", "sh", "t", "u", "v", "w", "x",
        "y", "z", "zh",
    ]
    punc = [",", ".", "?", "!", " ", "(", ")", ";", ":", "-", "'", '"',
            "，", "。", "、", "？", "！", "：", "；", "（", "）", "“", "”", "‘", "’", "—"]
    zh_toned = [p + t for p in ["a", "e", "er", "i", "o", "u", "v", "ng", "n", "m"]
                for t in "012345"]
    en_toned = [p + t for p in ["AA", "AE", "AH", "AO", "AW", "AX", "AY", "EH", "ER", "EY",
                                "IH", "IY", "OW", "OY", "UH", "UW"] for t in "012"]
    phones = ["_"] + zh_phones + en_phones + punc + zh_toned + en_toned + list("0123456789")
    return {p: i for i, p in enumerate(phones)}


def get_tokenizer(dataset_name: str, tokenizer: str = "custom",
                  data_dir: Optional[str] = None) -> Tuple[Optional[Dict[str, int]], int]:
    """(vocab_char_map, vocab_size): "char" reads
    {data_dir}/{dataset_name}_char/vocab.txt (data_dir defaults to ./data;
    space must be id 0); "custom" reads the vocab file at `dataset_name`;
    "byte" is UTF-8 with no map and size 256 (reference: utils.py:136-170)."""
    if tokenizer == "byte":
        return None, 256
    if tokenizer == "custom":
        vocab = load_vocab_file(dataset_name)
        return vocab, len(vocab)
    if tokenizer == "char":
        base = data_dir or os.path.join(os.getcwd(), "data")
        vocab = load_vocab_file(os.path.join(base, f"{dataset_name}_{tokenizer}", "vocab.txt"))
        if vocab.get(" ") != 0:
            raise ValueError("space must be id 0 in vocab.txt (0 = unknown)")
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


def split_rime(rime: str) -> List[str]:
    """A toned Mandarin rime at vocab granularity: the tone digit rides with a
    final 'er'/'ng' (else the last char), every char before it is a phone of
    its own: 'iang3' -> ['i', 'a', 'ng3'] (reference: model/dataset.py:141-154)."""
    if not rime or not rime[-1].isdigit():
        raise ValueError(f"rime must end in a tone digit: {rime!r}")
    if len(rime) >= 3 and rime[-3:-1] in ("er", "ng"):
        last, rime = rime[-3:], rime[:-3]
    else:
        last, rime = rime[-2:], rime[:-2]
    return list(rime) + [last]


def g2p_mix_process_token(token) -> List[str]:
    """One g2p-mix token (`.phones`, `.lang`) -> phones at training
    granularity: ZH finals rime-split, NUM tokens as single digits, the rest
    as they are (reference: model/dataset.py:156-164)."""
    phones = list(token.phones)
    if token.lang == "ZH":
        phones = phones[:-1] + split_rime(phones[-1])
    if token.lang == "NUM":
        phones = list(phones[0])
    return phones


def intersperse(texts: Sequence[Sequence[str]], sep: str = "_") -> List[List[str]]:
    """[a, b] -> [_, a, _, b, _] per sentence (reference: durpred/utils.py:10-16)."""
    out = []
    for sent in texts:
        row = [sep] * (len(sent) * 2 + 1)
        row[1::2] = list(sent)
        out.append(row)
    return out


_ONSETS = ("b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h", "j", "q", "x", "zh", "ch",
           "sh", "r", "z", "c", "s", "y", "w")


def split_pinyin(pinyin: str) -> List[str]:
    """One syllable -> [onset?, medial?, rime, coda?], trying onsets, codas
    ("n" before "ng") and medials in the reference's list order
    (reference: utils.py:174-211)."""
    onset = medial = coda = None
    for o in _ONSETS:
        if pinyin.startswith(o):
            onset, pinyin = o, pinyin[len(o):]
            break
    for c in ("n", "ng"):
        if pinyin.endswith(c):
            coda, pinyin = c, pinyin[: -len(c)]
            break
    for m in ("i", "u", "ü"):
        if pinyin.startswith(m):
            medial, pinyin = m, pinyin[len(m):]
            break
    return [x for x in (onset, medial, pinyin, coda) if x]


def repetition_found(text: str, length: int = 2, tolerance: int = 10) -> bool:
    """True when some `length`-gram occurs more than `tolerance` times, the
    dirty-data filter (reference: utils.py:317-325)."""
    counts: Dict[str, int] = defaultdict(int)
    for i in range(len(text) - length + 1):
        counts[text[i : i + length]] += 1
    return any(c > tolerance for c in counts.values())
