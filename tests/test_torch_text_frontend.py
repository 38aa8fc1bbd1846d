"""The text front end of the port (`utils/text.py`) and every entry point that
tokenizes, against the JAX package on the same inputs on the CPU.

- jieba and pypinyin are stand-ins put into `sys.modules` (a deterministic
  `cut`, `dt.initialized`, `Style.TONE3`/`TONE` and a small `lazy_pinyin`
  table), so both packages' `convert_char_to_pinyin` and
  `convert_char_to_finer_pinyin` run the same segments: pure ASCII, pure
  CJK, mixed, fullwidth punctuation, curly quotes, `polyphone=False`.
- g2p-mix runs through a fixture phonemizer shaped like g2p_mix.G2pMix (ZH,
  EN, NUM and SYM tokens), in both conventions, with the " n't" fix-up.
- A missing jieba, pypinyin or g2p_mix raises ImportError naming it.
- `get_tokenizer` for all six names; `prepare(tokenizer="pinyin")` writes
  the JAX vocab.txt with and without the stand-ins; `train.make_tokenize`,
  the finetune CLI's closure and `TTSEngine.tokenize` give JAX's ids for
  each tokenizer, with intersperse on and off.
- `F5TTS` over a tiny g2p-mix model YAML: 217 text-embedding rows in both
  packages, the same phone ids, and a 2-step fp32 synthesis on the JAX
  weights (`dit_from_jax`), each side drawing its own noise for the seed
  (the port's is JAX's threefry stream), within 1e-4.
"""

import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from f5e_tts_tpu.api import F5TTS as JF5TTS
from f5e_tts_tpu.config import InferConfig as JInferConfig
from f5e_tts_tpu.data import prepare as jprep
from f5e_tts_tpu.infer import pipeline as jpipe
from f5e_tts_tpu.train import finetune_cli as jft
from f5e_tts_tpu.train.train import make_tokenize as jmake_tokenize
from f5e_tts_tpu.utils import text as jtext
from f5e_tts_tpu_torch import api as tapi
from f5e_tts_tpu_torch.config import InferConfig
from f5e_tts_tpu_torch.data import prepare as tprep
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.infer.audio import write_wav
from f5e_tts_tpu_torch.train import finetune_cli as tft
from f5e_tts_tpu_torch.train.train import make_tokenize as tmake_tokenize
from f5e_tts_tpu_torch.utils import text as ttext
from f5e_tts_tpu_torch.utils.convert import dit_from_jax

# ---------------------------------------------------------------------------
# stand-in jieba / pypinyin and the fixture phonemizer
# ---------------------------------------------------------------------------

# char -> (TONE3, TONE) syllables
PINYIN = {"你": ("ni3", "nǐ"), "好": ("hao3", "hǎo"), "中": ("zhong1", "zhōng"),
          "文": ("wen2", "wén"), "想": ("xiang3", "xiǎng"), "略": ("lve4", "lüè"),
          "股": ("gu3", "gǔ"), "安": ("an1", "ān"), "二": ("er4", "èr"), "们": ("men5", "men")}
# ASCII words, an ASCII word glued to one CJK char (a mixed segment), CJK in
# pairs, runs of spaces, any other single char
_CUT = re.compile(r"[A-Za-z]+[一-鿿]|[A-Za-z0-9'.:]+|[一-鿿]{1,2}|\s+|.")


def _stand_ins():
    jieba = types.ModuleType("jieba")
    jieba.cut = lambda text: iter(_CUT.findall(text))
    jieba.dt = types.SimpleNamespace(initialized=True)
    pypinyin = types.ModuleType("pypinyin")
    pypinyin.Style = types.SimpleNamespace(TONE3="tone3", TONE="tone")

    def lazy_pinyin(text, style=None, tone_sandhi=False):
        assert tone_sandhi
        i = 0 if style == "tone3" else 1
        return [PINYIN[c][i] if c in PINYIN else c for c in text]

    pypinyin.lazy_pinyin = lazy_pinyin
    return jieba, pypinyin


@pytest.fixture
def g2p_modules(monkeypatch):
    jieba, pypinyin = _stand_ins()
    monkeypatch.setitem(sys.modules, "jieba", jieba)
    monkeypatch.setitem(sys.modules, "pypinyin", pypinyin)


class Tok:
    """A g2p_mix token: `.phones` and `.lang`."""

    def __init__(self, phones, lang):
        self.phones, self.lang = phones, lang


class FixedG2p:
    """The fixture of tests/test_text.py: one token list whatever the text."""

    def __init__(self):
        self.calls = []

    def g2p(self, text):
        self.calls.append(text)
        return [Tok(["n", "i3"], "ZH"), Tok(["h", "ao3"], "ZH"), Tok([","], "SYM"),
                Tok(["HH", "AH0", "L", "OW1"], "EN"), Tok(["123"], "NUM"),
                Tok(["x", "iang3"], "ZH")]


class TextG2p:
    """A phonemizer whose tokens follow the text: a CJK char is a ZH token
    (onset + toned single-vowel final), an ASCII word an EN token (one phone
    a letter), digits a NUM token, punctuation a SYM token. Every phone is
    in the g2p-mix inventory, but a NUM token of two digits or more."""

    EN = {"a": "AH0", "e": "EH1", "i": "IY1", "o": "OW1", "u": "UW1"}

    def g2p(self, text):
        out = []
        for m in re.finditer(r"[一-鿿]|[A-Za-z']+|\d+|[^\sA-Za-z\d]", text):
            s = m.group()
            if "一" <= s <= "鿿":
                out.append(Tok(["zh", "aeiou"[ord(s) % 5] + str(ord(s) % 4 + 1)], "ZH"))
            elif s[0].isalpha() or s[0] == "'":
                out.append(Tok([self.EN.get(c, c.upper() if c.upper() in
                                            ("B", "D", "F", "K", "L", "M", "N", "S", "T")
                                            else "HH") for c in s.lower()], "EN"))
            elif s.isdigit():
                out.append(Tok([s], "NUM"))
            else:
                out.append(Tok([s], "SYM"))
        return out


TEXTS = ["hello world", "it's a test: ok.", "你好中文", "hello 你好, A股 world",
         "“引号” ‘single’; semi", "你好，想 二 们", "略安 lve"]


# ---------------------------------------------------------------------------
# the converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("polyphone", [True, False])
@pytest.mark.parametrize("fn", ["convert_char_to_pinyin", "convert_char_to_finer_pinyin"])
@pytest.mark.parametrize("text", TEXTS)
def test_pinyin_converters_match_jax(g2p_modules, text, fn, polyphone):
    got = getattr(ttext, fn)([text, text.upper()], polyphone=polyphone)
    want = getattr(jtext, fn)([text, text.upper()], polyphone=polyphone)
    assert got == want
    assert not any(c in tok for tok in got[0] for c in "“”‘’;")  # the quote/semicolon table


def test_pinyin_converters_tokens(g2p_modules):
    """What the stand-ins make of a mixed text, spelled out."""
    assert ttext.convert_char_to_pinyin(["hi 你好"])[0] == ["h", "i", " ", " ", "ni3", " ",
                                                             "hao3"]
    assert ttext.convert_char_to_finer_pinyin(["想"])[0] == ["x_zh", "i_zh", "ǎ_zh", "ng_zh"]
    assert ttext.convert_char_to_finer_pinyin(["略"])[0] == ["l_zh", "ü_zh", "è_zh"]


@pytest.mark.parametrize("missing", ["jieba", "pypinyin"])
@pytest.mark.parametrize("fn", ["convert_char_to_pinyin", "convert_char_to_finer_pinyin"])
def test_pinyin_converters_raise_without_their_packages(monkeypatch, missing, fn):
    jieba, pypinyin = _stand_ins()
    monkeypatch.setitem(sys.modules, "jieba", jieba)
    monkeypatch.setitem(sys.modules, "pypinyin", pypinyin)
    monkeypatch.setitem(sys.modules, missing, None)
    for mod in (jtext, ttext):
        with pytest.raises(ImportError, match="jieba and pypinyin|jieba \\+ pypinyin"):
            getattr(mod, fn)(["你好"])


# ---------------------------------------------------------------------------
# g2p-mix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split_rimes,want", [
    (True, ["n", "i3", " ", "h", "a", "o3", ",", " ", "HH", "AH0", "L", "OW1",
            " ", "1", "2", "3", " ", "x", "i", "a", "ng3"]),
    (False, ["n", "i3", " ", "h", "ao3", ",", " ", "HH", "AH0", "L", "OW1",
             " ", "123", " ", "x", "iang3"]),
])
def test_g2p_mix_phonemize_matches_jax(split_rimes, want):
    got = ttext.g2p_mix_phonemize(["a", "b"], split_rimes=split_rimes, g2p=FixedG2p())
    assert got == jtext.g2p_mix_phonemize(["a", "b"], split_rimes=split_rimes, g2p=FixedG2p())
    assert got == [want, want]
    texts = ["你好, hello 42 world.", "do n't stop", ""]
    assert (ttext.g2p_mix_phonemize(texts, split_rimes=split_rimes, g2p=TextG2p())
            == jtext.g2p_mix_phonemize(texts, split_rimes=split_rimes, g2p=TextG2p()))


def test_g2p_mix_nt_fixup_on_the_training_side_only():
    for mod in (jtext, ttext):
        g = FixedG2p()
        mod.g2p_mix_phonemize(["do n't stop"], split_rimes=True, g2p=g)
        mod.g2p_mix_phonemize(["do n't stop"], split_rimes=False, g2p=g)
        assert g.calls == ["don't stop", "do n't stop"]


def test_g2p_mix_singleton_and_import_error(monkeypatch):
    monkeypatch.setattr(ttext, "_g2p_singleton", FixedG2p())
    assert ttext.g2p_mix_phonemize(["x"], split_rimes=True)[0][:2] == ["n", "i3"]
    monkeypatch.setitem(sys.modules, "g2p_mix", None)
    for mod in (jtext, ttext):
        monkeypatch.setattr(mod, "_g2p_singleton", None)
        with pytest.raises(ImportError, match="g2p_mix"):
            mod.g2p_mix_phonemize(["hi"], split_rimes=False)


# ---------------------------------------------------------------------------
# get_tokenizer and prepare
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pinyin", "char", "char-level-pinyin", "phone-level-pinyin",
                                  "custom", "byte", "g2p-mix"])
def test_get_tokenizer_matches_jax(tmp_path, name):
    for tok in ("pinyin", "char", "char-level-pinyin", "phone-level-pinyin"):
        (tmp_path / f"set_{tok}").mkdir()
        (tmp_path / f"set_{tok}" / "vocab.txt").write_text(" \nni3\nhao3\n", "utf-8")
    ds = str(tmp_path / "set_char" / "vocab.txt") if name == "custom" else "set"
    got = ttext.get_tokenizer(ds, name, data_dir=str(tmp_path))
    assert got == jtext.get_tokenizer(ds, name, data_dir=str(tmp_path))
    assert got[1] == {"byte": 256, "g2p-mix": 216}.get(name, 3)


def test_get_tokenizer_defaults_and_errors_as_jax(tmp_path, monkeypatch):
    (tmp_path / "data" / "set_pinyin").mkdir(parents=True)
    (tmp_path / "data" / "set_pinyin" / "vocab.txt").write_text(" \na\n", "utf-8")
    monkeypatch.chdir(tmp_path)  # data_dir defaults to ./data, the tokenizer to pinyin
    assert ttext.get_tokenizer("set") == jtext.get_tokenizer("set") == ({" ": 0, "a": 1}, 2)
    for mod in (jtext, ttext):
        with pytest.raises(ValueError, match="unknown tokenizer"):
            mod.get_tokenizer("set", "words")
    (tmp_path / "data" / "set_pinyin" / "vocab.txt").write_text("a\n \n", "utf-8")
    with pytest.raises(ValueError, match="space must be id 0"):
        ttext.get_tokenizer("set")


@pytest.mark.parametrize("with_g2p", [True, False])
def test_prepare_pinyin_vocab_matches_jax(tmp_path, monkeypatch, with_g2p):
    sr = 8000
    texts = ["你好 hello!", "中文, 想", "A股 world"]
    for i in range(3):
        write_wav(str(tmp_path / f"w{i}.wav"),
                  (0.2 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)).astype(np.float32), sr)
    (tmp_path / "metadata.csv").write_text(
        "audio_file|text\n" + "".join(f"w{i}.wav|{t}\n" for i, t in enumerate(texts)), "utf-8")
    if with_g2p:
        jieba, pypinyin = _stand_ins()
        monkeypatch.setitem(sys.modules, "jieba", jieba)
        monkeypatch.setitem(sys.modules, "pypinyin", pypinyin)
    else:
        monkeypatch.setitem(sys.modules, "pypinyin", None)
    vocabs, stats = [], []
    for name, mod in (("jax", jprep), ("torch", tprep)):
        stats.append(mod.prepare(mod.rows_from_csv(str(tmp_path)), str(tmp_path / name),
                                 tokenizer="pinyin", workers=1))
        vocabs.append((tmp_path / name / "vocab.txt").read_bytes())
    assert vocabs[0] == vocabs[1] and stats[0] == stats[1]
    lines = vocabs[1].decode().split("\n")
    assert lines[0] == " " and (("ni3" in lines) == with_g2p) and (("你" in lines) != with_g2p)


# ---------------------------------------------------------------------------
# the tokenize closures of training, finetuning and inference
# ---------------------------------------------------------------------------

TOKENIZERS = ["pinyin", "char-level-pinyin", "phone-level-pinyin", "g2p-mix", "char", "byte"]
BATCH = ["你好 hello, 想 world 7.", "A股 do n't 中文!", "ok"]


def _vocab(name):
    """A vocab over everything the stand-ins emit for BATCH (space at 0), or
    the g2p-mix inventory; a few tokens are left out, so unknown ids show."""
    if name == "g2p-mix":
        return jtext.g2p_mix_vocab()
    toks = set()
    for conv in (jtext.convert_char_to_pinyin, jtext.convert_char_to_finer_pinyin):
        toks |= {t for row in conv(BATCH) for t in row}
    toks |= {c for t in BATCH for c in t} | {"_"}
    return {t: i for i, t in enumerate([" "] + sorted(toks - {" ", "hao3", "w"}))}


def _arch(intersperse):
    if not intersperse:
        return types.SimpleNamespace()
    return types.SimpleNamespace(codebook=types.SimpleNamespace(use_align_loss=True),
                                 ppg=types.SimpleNamespace(use_cross_mask=False))


@pytest.mark.parametrize("intersperse", [False, True])
@pytest.mark.parametrize("name", TOKENIZERS)
def test_make_tokenize_matches_jax(g2p_modules, monkeypatch, name, intersperse):
    for mod in (jtext, ttext):
        monkeypatch.setattr(mod, "_g2p_singleton", TextG2p())
    cfg = types.SimpleNamespace(tokenizer=name, arch=_arch(intersperse))
    vocab = _vocab(name)
    got = tmake_tokenize(cfg, vocab)(BATCH)
    np.testing.assert_array_equal(got, jmake_tokenize(cfg, vocab)(BATCH))
    if name == "g2p-mix":  # phone ids, none unknown ("_", the separator, is id 0)
        row = got[0, 1::2] if intersperse else got[0]
        assert (row[row >= 0] > 0).all() and vocab["7"] in row and vocab["zh"] in row


@pytest.mark.parametrize("intersperse", [False, True])
@pytest.mark.parametrize("name", TOKENIZERS)
def test_engine_tokenize_matches_jax(g2p_modules, name, intersperse):
    vocab = None if name == "byte" else _vocab(name)
    jeng = jpipe.TTSEngine(params=None, state=None, arch=None, vocab=vocab, tokenizer=name,
                           use_intersperse=intersperse)
    teng = tpipe.TTSEngine(params={}, arch=None, vocab=vocab, tokenizer=name,
                           use_intersperse=intersperse, device="cpu", _g2p=TextG2p())
    jeng._g2p = TextG2p()
    got = teng.tokenize(BATCH)
    np.testing.assert_array_equal(got, jeng.tokenize(BATCH))
    if name == "g2p-mix":  # phone ids, none unknown ("_", the separator, is id 0)
        row = got[0, 1::2] if intersperse else got[0]
        assert (row[row >= 0] > 0).all() and vocab["7"] in row


class _Stop(Exception):
    pass


def _finetune_closure(mod, dataset_mod, monkeypatch, tmp_path, name):
    """The tokenize function a finetune CLI's main hands its loader."""
    got = []

    def build_loader(dataset, tokenize, **kw):
        got.append(tokenize)
        raise _Stop

    monkeypatch.setattr(dataset_mod.ArrowSpeechDataset, "from_dir",
                        classmethod(lambda cls, *a, **k: None))
    monkeypatch.setattr(dataset_mod, "build_loader", build_loader)
    argv = ["--dataset_name", "set", "--data_dir", str(tmp_path / "data"), "--tokenizer", name]
    with pytest.raises(_Stop):
        mod.main(argv + (["--device", "cpu"] if mod is tft else []))
    return got[0]


@pytest.mark.parametrize("name", TOKENIZERS)
def test_finetune_closure_matches_jax(g2p_modules, monkeypatch, tmp_path, name):
    from f5e_tts_tpu.data import dataset as jdataset
    from f5e_tts_tpu_torch.data import dataset as tdataset

    monkeypatch.chdir(tmp_path)  # the CLIs make ckpts/<dataset_name>/ here
    for mod in (jtext, ttext):
        monkeypatch.setattr(mod, "_g2p_singleton", TextG2p())
    vocab = _vocab(name)
    if name not in ("byte", "g2p-mix"):
        (tmp_path / "data" / f"set_{name}").mkdir(parents=True)
        (tmp_path / "data" / f"set_{name}" / "vocab.txt").write_text(
            "".join(f"{t}\n" for t in vocab), "utf-8")
    want = _finetune_closure(jft, jdataset, monkeypatch, tmp_path, name)(BATCH)
    got = _finetune_closure(tft, tdataset, monkeypatch, tmp_path, name)(BATCH)
    np.testing.assert_array_equal(got, want)
    if name != "byte":
        np.testing.assert_array_equal(tft.finetune_tokenize(name, vocab)(BATCH), want)


# ---------------------------------------------------------------------------
# F5TTS over a g2p-mix model config
# ---------------------------------------------------------------------------

TINY = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, text_dim=16, conv_layers=1,
            dropout=0.0)
REF, DURATION, BUCKET, SEED = 40, 100, 128, 5
CHUNK_TEXT = "Some words, 你好 7."


@pytest.fixture(scope="module")
def g2p_f5tts(tmp_path_factory):
    """(JAX F5TTS, port F5TTS) over one tiny g2p-mix YAML, the port on the
    JAX weights (every zero leaf filled with seeded values), both engines on
    the TextG2p phonemizer, one bucket and 2 steps."""
    path = tmp_path_factory.mktemp("g2p") / "tiny.yaml"
    path.write_text(yaml.safe_dump({"model": {"name": "tiny", "backbone": "DiT",
                                              "tokenizer": "g2p-mix", "arch": TINY}}), "utf-8")
    jtts = JF5TTS(config_file=str(path), compute_dtype=jnp.float32)
    ttts = tapi.F5TTS(config_file=str(path), compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: np.asarray(a) if np.asarray(a).any()
                          else (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                          jtts.engine.params)
    jtts.engine.params = jax.tree.map(jnp.asarray, params)
    ttts.engine.params = dit_from_jax(params, ttts.engine.arch)
    for tts in (jtts, ttts):
        tts.engine._g2p = TextG2p()
        tts.engine.buckets = (BUCKET,)
    jtts.engine.infer_cfg = JInferConfig(nfe_steps=2)
    ttts.engine.infer_cfg = InferConfig(nfe_steps=2)
    return jtts, ttts


def test_f5tts_g2p_mix_config_builds_the_phone_table(g2p_f5tts):
    jtts, ttts = g2p_f5tts
    assert jtts.engine.tokenizer == ttts.engine.tokenizer == "g2p-mix"
    assert jtts.engine.vocab == ttts.engine.vocab == ttext.g2p_mix_vocab()
    rows = (np.asarray(jtts.engine.params["text_embed"]["embed"]["w"]).shape[0],
            ttts.engine.params["text_embed"]["embed"]["w"].shape[0])
    assert rows == (217, 217)
    ids = ttts.engine.tokenize([CHUNK_TEXT])
    np.testing.assert_array_equal(ids, jtts.engine.tokenize([CHUNK_TEXT]))
    assert (ids > 0).all()  # phone ids, none unknown


def test_f5tts_g2p_mix_synthesis_matches_jax(g2p_f5tts):
    jtts, ttts = g2p_f5tts
    ref_mel = np.random.default_rng(3).standard_normal((1, REF, 100)).astype(np.float32)
    want = jtts.engine.synthesize_chunk(ref_mel, CHUNK_TEXT, DURATION, seed=SEED)
    got = ttts.engine.synthesize_chunk(ref_mel, CHUNK_TEXT, DURATION, seed=SEED)
    assert got.shape == (DURATION - REF, 100) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
