"""Tokenizers and the text front end (counterpart of `f5e_tts_tpu/utils/text.py`).

Every tokenizer of the JAX package: "pinyin", "char", "char-level-pinyin"
and "phone-level-pinyin" (a vocab.txt per dataset), "custom" (a vocab file),
"byte" (UTF-8) and "g2p-mix" (the built-in phone inventory); the pinyin
converters (`convert_char_to_pinyin`, `convert_char_to_finer_pinyin`), the
g2p-mix phonemizer (`g2p_mix_phonemize`), the id mapping and the helpers.
jieba, pypinyin and g2p_mix are optional: each is imported inside the
function that needs it, which raises ImportError naming it when it is
absent; nothing falls through to characters. (reference:
src/f5_tts/model/utils.py:80-325, model/dataset.py:141-181,
durpred/utils.py:10-16)
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


def get_tokenizer(dataset_name: str, tokenizer: str = "pinyin",
                  data_dir: Optional[str] = None) -> Tuple[Optional[Dict[str, int]], int]:
    """(vocab_char_map, vocab_size): "pinyin", "char", "char-level-pinyin" and
    "phone-level-pinyin" read {data_dir}/{dataset_name}_{tokenizer}/vocab.txt
    (data_dir defaults to ./data; space must be id 0); "custom" reads the
    vocab file at `dataset_name`; "byte" is UTF-8 with no map and size 256;
    "g2p-mix" is `g2p_mix_vocab()` (reference: utils.py:136-170)."""
    if tokenizer in ("pinyin", "char", "char-level-pinyin", "phone-level-pinyin"):
        base = data_dir or os.path.join(os.getcwd(), "data")
        vocab = load_vocab_file(os.path.join(base, f"{dataset_name}_{tokenizer}", "vocab.txt"))
        if vocab.get(" ") != 0:
            raise ValueError("space must be id 0 in vocab.txt (0 = unknown)")
        return vocab, len(vocab)
    if tokenizer == "byte":
        return None, 256
    if tokenizer == "custom":
        vocab = load_vocab_file(dataset_name)
        return vocab, len(vocab)
    if tokenizer == "g2p-mix":
        vocab = g2p_mix_vocab()
        return vocab, len(vocab)
    raise ValueError(f"unknown tokenizer {tokenizer!r}")


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


_g2p_singleton = None  # the G2pMix phonemizer, built at first use


def g2p_mix_phonemize(texts: Sequence[str], *, split_rimes: bool,
                      g2p=None) -> List[List[str]]:
    """Texts -> phone lists through a g2p_mix phonemizer, with " " before
    every token after the first that is not a symbol. `split_rimes=True` is
    the training side's convention (" n't" re-attached, ZH rimes and NUM
    digits split: model/dataset.py:166-181), False the inference side's (the
    raw phones: eval/utils_eval.py:135-137). `g2p` is a phonemizer with
    `.g2p(text)` -> tokens (`.phones`, `.lang`); without it the module's
    `G2pMix()` singleton, and ImportError naming g2p_mix when that package is
    absent."""
    if g2p is None:
        global _g2p_singleton
        if _g2p_singleton is None:
            try:
                from g2p_mix import G2pMix
            except ImportError as e:
                raise ImportError(
                    "tokenizer='g2p-mix' needs the g2p_mix package, which is not installed: "
                    "install g2p-mix or choose another tokenizer (characters would give ids "
                    "outside the phone vocab)") from e
            _g2p_singleton = G2pMix()
        g2p = _g2p_singleton
    proc = g2p_mix_process_token if split_rimes else (lambda t: list(t.phones))
    out: List[List[str]] = []
    for text in texts:
        if split_rimes:
            text = text.replace(" n't", "n't")  # LibriTTS spaces "n't" out (dataset.py:176)
        items = g2p.g2p(text)
        phones = proc(items[0]) if items else []
        for token in items[1:]:
            phones += proc(token) if token.lang == "SYM" else [" "] + proc(token)
        out.append(phones)
    return out


def intersperse(texts: Sequence[Sequence[str]], sep: str = "_") -> List[List[str]]:
    """[a, b] -> [_, a, _, b, _] per sentence (reference: durpred/utils.py:10-16)."""
    out = []
    for sent in texts:
        row = [sep] * (len(sent) * 2 + 1)
        row[1::2] = list(sent)
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# Chinese g2p (pinyin): jieba and pypinyin, imported where they are used
# ---------------------------------------------------------------------------

_CUSTOM_TRANS = str.maketrans({";": ",", "“": '"', "”": '"', "‘": "'", "’": "'"})


def _is_chinese(c: str) -> bool:
    return "\u3100" <= c <= "\u9fff"


def _require_g2p():
    """ImportError naming jieba and pypinyin unless both import; jieba's
    dictionary loaded quietly."""
    try:
        import jieba
        from pypinyin import Style, lazy_pinyin  # noqa: F401
    except ImportError as e:
        raise ImportError("Chinese g2p needs jieba and pypinyin; install them or use the "
                          "'char' or 'byte' tokenizer for text without Chinese") from e
    if not jieba.dt.initialized:
        jieba.default_logger.setLevel(50)
        jieba.initialize()


def convert_char_to_pinyin(text_list: Sequence[str], polyphone: bool = True) -> List[List[str]]:
    """Mixed Chinese/English texts -> token lists: ASCII segments as their
    characters (a space before a multi-character one), each Chinese
    character as " " and its TONE3 pinyin syllable (reference: utils.py:270-311)."""
    _require_g2p()
    import jieba
    from pypinyin import Style, lazy_pinyin

    final: List[List[str]] = []
    for text in text_list:
        chars: List[str] = []
        for seg in jieba.cut(text.translate(_CUSTOM_TRANS)):
            seg_bytes = len(bytes(seg, "utf-8"))
            if seg_bytes == len(seg):  # pure ASCII
                if chars and seg_bytes > 1 and chars[-1] not in " :'\"":
                    chars.append(" ")
                chars.extend(seg)
            elif polyphone and seg_bytes == 3 * len(seg):  # pure CJK
                pys = lazy_pinyin(seg, style=Style.TONE3, tone_sandhi=True)
                for i, c in enumerate(seg):
                    if _is_chinese(c):
                        chars.append(" ")
                    chars.append(pys[i])
            else:  # mixed
                for c in seg:
                    if ord(c) < 256:
                        chars.extend(c)
                    elif _is_chinese(c):
                        chars.append(" ")
                        chars.extend(lazy_pinyin(c, style=Style.TONE3, tone_sandhi=True))
                    else:
                        chars.append(c)
        final.append(chars)
    return final


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


def convert_char_to_finer_pinyin(text_list: Sequence[str],
                                 polyphone: bool = True) -> List[List[str]]:
    """As `convert_char_to_pinyin`, with each Chinese syllable (TONE style)
    split by `split_pinyin` into parts suffixed "_zh", a space before it
    unless one is there (reference: utils.py:217-264)."""
    _require_g2p()
    import jieba
    from pypinyin import Style, lazy_pinyin

    final: List[List[str]] = []
    for text in text_list:
        chars: List[str] = []
        for seg in jieba.cut(text.translate(_CUSTOM_TRANS)):
            seg_bytes = len(bytes(seg, "utf-8"))
            if seg_bytes == len(seg):
                if chars and seg_bytes > 1 and chars[-1] not in " :'\"":
                    chars.append(" ")
                chars.extend(seg)
            elif polyphone and seg_bytes == 3 * len(seg):
                pys = lazy_pinyin(seg, style=Style.TONE, tone_sandhi=True)
                for i, c in enumerate(seg):
                    if _is_chinese(c):
                        if chars and chars[-1] not in " :'\"":
                            chars.append(" ")
                        chars.extend(part + "_zh" for part in split_pinyin(pys[i]))
                    else:
                        chars.extend(list(pys[i]))
            else:
                for c in seg:
                    if ord(c) < 256:
                        chars.extend(c)
                    elif _is_chinese(c):
                        if chars and chars[-1] not in " :'\"":
                            chars.append(" ")
                        syllable = lazy_pinyin(c, style=Style.TONE, tone_sandhi=True)[0]
                        chars.extend(part + "_zh" for part in split_pinyin(syllable))
                    else:
                        chars.append(c)
        final.append(chars)
    return final


def repetition_found(text: str, length: int = 2, tolerance: int = 10) -> bool:
    """True when some `length`-gram occurs more than `tolerance` times, the
    dirty-data filter (reference: utils.py:317-325)."""
    counts: Dict[str, int] = defaultdict(int)
    for i in range(len(text) - length + 1):
        counts[text[i : i + length]] += 1
    return any(c > tolerance for c in counts.values())
