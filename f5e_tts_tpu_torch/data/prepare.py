"""Dataset preparation: audio+transcript corpora -> Arrow + duration.json + vocab.txt
(counterpart of `f5e_tts_tpu/data/prepare.py`, on the port's `utils/text.py`).

reference: src/f5_tts/train/datasets/prepare_csv_wavs.py (generic CSV corpus),
prepare_libritts.py, prepare_emilia*.py, prepare_ljspeech.py,
prepare_wenetspeech4tts.py. One generic pipeline here covers the same output
contract (data/{name}_{tokenizer}/raw.arrow + duration.json + vocab.txt);
per-corpus front-ends are thin manifest builders.

Usage:
  python -m f5e_tts_tpu_torch.data.prepare csv --input corpus_dir --output data/my_pinyin
  python -m f5e_tts_tpu_torch.data.prepare ljspeech --input LJSpeech-1.1 --output ...

The "pinyin" tokenizer (the default) takes its vocab from the texts'
`convert_char_to_pinyin` tokens; when jieba or pypinyin is absent it takes
the texts' characters, which is the JAX package's rule. Every other name
takes the characters.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Iterable, Tuple

from f5e_tts_tpu_torch.utils.text import convert_char_to_pinyin, repetition_found


def _duration_of(path: str) -> float:
    """Wav duration in seconds without decoding samples."""
    import wave

    with wave.open(path, "rb") as f:
        return f.getnframes() / f.getframerate()


def rows_from_csv(input_dir: str) -> Iterable[Tuple[str, str]]:
    """metadata.csv with `audio_file|text` rows (prepare_csv_wavs.py layout)."""
    meta = os.path.join(input_dir, "metadata.csv")
    with open(meta, "r", encoding="utf-8-sig") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) != 2 or parts[0] == "audio_file":
                continue
            wav = parts[0]
            if not os.path.isabs(wav):
                wav = os.path.join(input_dir, wav)
            yield wav, parts[1]


def rows_from_ljspeech(input_dir: str) -> Iterable[Tuple[str, str]]:
    """LJSpeech metadata.csv: id|raw|normalized (prepare_ljspeech.py)."""
    meta = os.path.join(input_dir, "metadata.csv")
    with open(meta, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 3:
                continue
            yield os.path.join(input_dir, "wavs", parts[0] + ".wav"), parts[2]


def rows_from_libritts(input_dir: str) -> Iterable[Tuple[str, str]]:
    """LibriTTS layout: */*/*.wav with .normalized.txt (prepare_libritts.py:17-94)."""
    for root, _dirs, files in os.walk(input_dir):
        for name in files:
            if name.endswith(".wav"):
                txt = os.path.join(root, name.replace(".wav", ".normalized.txt"))
                if os.path.exists(txt):
                    with open(txt, "r", encoding="utf-8") as f:
                        yield os.path.join(root, name), f.read().strip()


def rows_from_emilia(input_dir: str, languages=("ZH", "EN")) -> Iterable[Tuple[str, str]]:
    """Emilia corpus: per-shard JSONL manifests {wav, text, language, dnsmos}.

    reference: train/datasets/prepare_emilia.py — language filter + repetition
    filter (applied downstream via filter_repetition=True) + out-of-charset
    symbols dropped by the tokenizer itself.
    """
    import json as _json

    for root, _dirs, files in os.walk(input_dir):
        for name in files:
            if not (name.endswith(".jsonl") or name.endswith(".json")):
                continue
            with open(os.path.join(root, name), "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = _json.loads(line)
                    except _json.JSONDecodeError:
                        continue
                    lang = obj.get("language", obj.get("lang", ""))
                    if languages and lang not in languages:
                        continue
                    wav = obj.get("wav") or obj.get("audio") or obj.get("path")
                    text = obj.get("text", "")
                    if not wav or not text:
                        continue
                    if not os.path.isabs(wav):
                        wav = os.path.join(root, wav)
                    yield wav, text


# Emilia-YODAS junk-charset filters + zh punctuation normalization
# (reference: train/datasets/prepare_emilia_v2.py:18-43)
_ZH_BAD = ("い", "て")
_EN_BAD = ("ا", "い", "て")
_ZH_PUNCT = str.maketrans({",": "，", "!": "！", "?": "？"})


def rows_from_emilia_v2(input_dir: str, languages=("EN", "ZH")) -> Iterable[tuple]:
    """Emilia-YODAS layout (prepare_emilia_v2.py:23-118): <split>/<LANG>/<dir>/
    with one .json per utterance {text, language, duration} and a sibling
    .mp3/.wav. Applies the reference's per-language junk filters, repetition
    filter (en: length 4, zh: length 2), and zh halfwidth->fullwidth
    punctuation. Duration comes from the manifest (no audio decode)."""
    langs = {l.lower() for l in languages}
    for root, _dirs, files in os.walk(input_dir):
        for name in files:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(root, name), "r", encoding="utf-8") as f:
                    obj = json.load(f)
            except (json.JSONDecodeError, OSError, UnicodeDecodeError):
                continue
            if not isinstance(obj, dict):
                continue
            text = obj.get("text", "")
            lang = str(obj.get("language", "")).lower()
            if not text or (langs and lang not in langs):
                continue
            if lang == "en" and (any(c in text for c in _EN_BAD)
                                 or repetition_found(text, length=4)):
                continue
            if lang == "zh":
                if any(c in text for c in _ZH_BAD) or repetition_found(text):
                    continue
                text = text.translate(_ZH_PUNCT)
            stem = os.path.join(root, name[:-5])
            audio = next((stem + ext for ext in (".mp3", ".wav", ".flac")
                          if os.path.exists(stem + ext)), None)
            if audio is None:
                continue
            yield audio, text, float(obj.get("duration", 0.0))


def rows_from_wenetspeech4tts(input_dir: str) -> Iterable[Tuple[str, str]]:
    """WenetSpeech4TTS: wavs + paired .txt transcripts
    (reference: train/datasets/prepare_wenetspeech4tts.py)."""
    for root, _dirs, files in os.walk(input_dir):
        for name in files:
            if name.endswith(".wav"):
                txt = os.path.join(root, name[:-4] + ".txt")
                if os.path.exists(txt):
                    with open(txt, "r", encoding="utf-8") as f:
                        yield os.path.join(root, name), f.read().strip()


def _process_row(row, min_dur=0.3, max_dur=30.0, filter_repetition=False):
    if len(row) == 3:  # manifest-supplied duration (e.g. emilia_v2)
        wav, text, dur = row
    else:
        wav, text = row
        try:
            dur = _duration_of(wav)
        except Exception:
            return None
    if not (min_dur <= dur <= max_dur):
        return None
    if filter_repetition and repetition_found(text):
        return None
    return {"audio_path": wav, "text": text, "duration": dur}


def prepare(
    rows: Iterable[Tuple[str, str]],
    output_dir: str,
    tokenizer: str = "pinyin",
    workers: int = 4,
    filter_repetition: bool = False,
) -> dict:
    """Write raw.arrow + duration.json + vocab.txt (the load_dataset contract,
    reference dataset.py:309-373)."""
    os.makedirs(output_dir, exist_ok=True)
    import functools

    proc = functools.partial(_process_row, filter_repetition=filter_repetition)
    rows = list(rows)
    if workers > 1:
        with ProcessPoolExecutor(max_workers=workers) as ex:
            processed = list(ex.map(proc, rows, chunksize=64))
    else:
        processed = [proc(r) for r in rows]
    processed = [r for r in processed if r is not None]

    from datasets import Dataset as ArrowDataset
    from datasets.arrow_writer import ArrowWriter

    path = os.path.join(output_dir, "raw.arrow")
    if processed:
        with ArrowWriter(path=path) as writer:
            for r in processed:
                writer.write(r)
            writer.finalize()
    else:
        # typed empty dataset so downstream loaders still work
        empty = ArrowDataset.from_dict({"audio_path": [], "text": [], "duration": []})
        with ArrowWriter(path=path, features=empty.features) as writer:
            writer.finalize()

    with open(os.path.join(output_dir, "duration.json"), "w", encoding="utf-8") as f:
        json.dump({"duration": [r["duration"] for r in processed]}, f)

    # vocab from the tokenized texts; space pinned at index 0 (utils.py:153)
    texts = [r["text"] for r in processed]
    if tokenizer == "pinyin":
        try:
            tokenized = convert_char_to_pinyin(texts)
            chars = sorted({c for row in tokenized for c in row})
        except ImportError:  # no jieba/pypinyin: the characters, as the JAX package does
            chars = sorted({c for t in texts for c in t})
    else:
        chars = sorted({c for t in texts for c in t})
    vocab = [" "] + [c for c in chars if c != " "]
    with open(os.path.join(output_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")

    return {"rows": len(processed), "total_hours": sum(r["duration"] for r in processed) / 3600,
            "vocab_size": len(vocab)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("corpus", choices=["csv", "ljspeech", "libritts", "emilia",
                                      "emilia_v2", "wenetspeech4tts"])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--tokenizer", default="pinyin")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--filter_repetition", action="store_true")
    args = p.parse_args(argv)
    rows = {"csv": rows_from_csv, "ljspeech": rows_from_ljspeech,
            "libritts": rows_from_libritts, "emilia": rows_from_emilia,
            "emilia_v2": rows_from_emilia_v2,
            "wenetspeech4tts": rows_from_wenetspeech4tts}[args.corpus](args.input)
    stats = prepare(rows, args.output, args.tokenizer, args.workers,
                    args.filter_repetition)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
