"""Objective scorers: WER (ASR + jiwer-style edit distance), SIM (speaker
cosine), UTMOS (a copy of `f5e_tts_tpu/eval/scorers.py`, which imports no
JAX; its loaders point at the port's modules and devices).

reference: src/f5_tts/eval/utils_eval.py:400-753 + eval_seedtts_testset.py +
eval_utmos.py. The external scoring models (Whisper-large-v3, Paraformer,
WavLM-ECAPA, UTMOS) need weights on local disk; their loaders raise without
them, while the text normalisation, edit distance and result aggregation
(the harness's own logic) are here.
"""

from __future__ import annotations

import json
import os
import re
import string
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# edit distance / WER (jiwer-equivalent core)
# ---------------------------------------------------------------------------


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance over token sequences."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def wer(ref_words: Sequence[str], hyp_words: Sequence[str]) -> float:
    """Word error rate = edit distance / reference length."""
    if len(ref_words) == 0:
        return 0.0 if len(hyp_words) == 0 else 1.0
    return edit_distance(ref_words, hyp_words) / len(ref_words)


_PUNC_TABLE = str.maketrans("", "", string.punctuation + "。，、？！：；“”‘’（）—")

# zhon.hanzi.punctuation, vendored (zhon is not installed offline). The
# reference strips `zhon.hanzi.punctuation + string.punctuation` before
# seed-tts WER (utils_eval.py:509-511). non_stops + stops per zhon's docs.
ZH_PUNCTUATION = (
    "＂＃＄％＆＇（）＊＋，－"
    "／：；＜＝＞＠［＼］＾＿"
    "｀｛｜｝～｟｠"
    "｢｣､"
    "　、〃"
    "〈〉《》「」『』【】"
    "〔〕〖〗〘〙〚〛〜〝〞〟"
    "〰"
    "〾〿"
    "–—"
    "‘’‛“”„‟"
    "…‧"
    "﹏"
    "﹑﹔"
    "·"
    "！？｡。"
)

_UNITS = ["zero", "one", "two", "three", "four", "five", "six", "seven",
          "eight", "nine"]
_TEENS = ["ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
          "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "ten", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]


def number_to_words(n: int) -> str:
    """Digit verbalization with the reference's EXACT output conventions
    ("and" before sub-hundred remainders of thousands/hundreds), so WER
    normalization is token-for-token comparable. reference:
    utils_eval.py:566-603 (oracle-parity-tested)."""
    if n == 0:
        return _UNITS[0]
    words = []
    if n >= 1_000_000:
        words.append(number_to_words(n // 1_000_000) + " million")
        n %= 1_000_000
    if n >= 1000:
        words.append(number_to_words(n // 1000) + " thousand")
        n %= 1000
        if 0 < n < 100:
            words.append("and")
    if n >= 100:
        words.append(_UNITS[n // 100] + " hundred")
        n %= 100
        if n > 0:
            words.append("and")
    if n >= 20:
        words.append(_TENS[n // 10])
        n %= 10
    elif 10 <= n < 20:
        words.append(_TEENS[n - 10])
        n = 0
    if n > 0:
        words.append(_UNITS[n])
    return " ".join(words).replace(" and zero", "").replace("  ", " ")


def replace_mixed_numbers(text: str) -> str:
    """Verbalize digit runs inside mixed text (utils_eval.py:605-617)."""
    parts = re.findall(r"\d+|\D+", text)
    converted = [number_to_words(int(p)) if p.isdigit() else p for p in parts]
    return re.sub(r"\s+", " ", " ".join(converted)).strip()


def replace_special(text: str) -> str:
    """Reference's ad-hoc token fixes (utils_eval.py:619-628). The 18th/19th
    replacement is unconditional there (`if "18th" or "19th" in text` is
    always truthy) — behavior kept."""
    if "$" in text:
        text = text.replace("$", "")
        text += "dollars"
    text = text.replace("supercomputer", "super computer")
    text = text.replace("18th", "eighteenth").replace("19th", "nineteenth")
    return text


# ---------------------------------------------------------------------------
# jiwer-default-equivalent measures (strings in, rates out)
# ---------------------------------------------------------------------------


def _jiwer_words(s: str) -> List[str]:
    # jiwer wer_default: RemoveMultipleSpaces + Strip + split on space
    return [w for w in re.sub(r"\s+", " ", s).strip().split(" ") if w]


def jiwer_wer(truth: str, hypothesis: str) -> float:
    """jiwer.compute_measures(...)["wer"] semantics."""
    return wer(_jiwer_words(truth), _jiwer_words(hypothesis))


def jiwer_cer(truth: str, hypothesis: str) -> float:
    """jiwer.cer semantics (char-level over the stripped strings)."""
    r, h = list(truth.strip()), list(hypothesis.strip())
    if not r:
        return 0.0 if not h else 1.0
    return edit_distance(r, h) / len(r)


# ---------------------------------------------------------------------------
# the two reference WER normalization pipelines
# ---------------------------------------------------------------------------


def normalize_seedtts(truth: str, hypo: str, lang: str) -> Tuple[str, str]:
    """run_asr_wer's inline normalization (utils_eval.py:509-543): strip
    zh+ascii punctuation, single double-space collapse, zh char-split /
    en lowercase."""
    for x in ZH_PUNCTUATION + string.punctuation:
        truth = truth.replace(x, "")
        hypo = hypo.replace(x, "")
    truth = truth.replace("  ", " ")
    hypo = hypo.replace("  ", " ")
    if lang == "zh":
        truth = " ".join(truth)
        hypo = " ".join(hypo)
    elif lang == "en":
        truth = truth.lower()
        hypo = hypo.lower()
    return truth, hypo


def normalize_whisper_v3(truth: str, hypo: str, lang: str) -> Tuple[str, str]:
    """run_asr_wer_whisper_large_v3's inline normalization
    (utils_eval.py:676-697): ascii punctuation only, apostrophe variants,
    hyphen->space + non-word strip on the hypothesis, digit verbalization +
    special-token fixes on the hypothesis only."""
    for x in string.punctuation:
        truth = truth.replace(x, "")
        hypo = hypo.replace(x, "")
    truth = truth.replace("’", "")
    hypo = hypo.replace("’", "")
    truth = truth.replace("  ", " ")
    hypo = hypo.replace("  ", " ")
    hypo = hypo.replace("-", " ")
    hypo = re.sub(r"[^\w\s\']", "", hypo)
    if lang == "zh":
        truth = " ".join(truth)
        hypo = " ".join(hypo)
    elif lang == "en":
        truth = truth.lower()
        hypo = hypo.lower()
    hypo = replace_mixed_numbers(hypo)
    hypo = replace_special(hypo)
    return truth, hypo


def normalize_text_en(text: str) -> List[str]:
    """Lowercase, strip punctuation, verbalize digits -> word list."""
    text = text.lower()
    text = re.sub(r"\d+", lambda m: " " + number_to_words(int(m.group())) + " ", text)
    text = text.translate(_PUNC_TABLE)
    return text.split()


def normalize_text_zh(text: str) -> List[str]:
    """Character-level tokens for CER."""
    text = text.translate(_PUNC_TABLE).replace(" ", "")
    return list(text)


def score_wer(
    pairs: Sequence[Tuple[str, str, str]],  # (utt, ref_text, hyp_text)
    lang: str = "en",
    results_path: Optional[str] = None,
) -> Dict[str, float]:
    """Compute corpus WER/CER + per-utt jsonl (eval_seedtts_testset.py:76-85)."""
    norm = normalize_text_en if lang == "en" else normalize_text_zh
    rows = []
    total_err, total_ref = 0, 0
    for utt, ref, hyp in pairs:
        r, h = norm(ref), norm(hyp)
        e = edit_distance(r, h)
        total_err += e
        total_ref += max(len(r), 1)
        rows.append({"utt": utt, "wer": e / max(len(r), 1),
                     "ref": " ".join(r), "hyp": " ".join(h)})
    mean = total_err / max(total_ref, 1)
    if results_path:
        with open(results_path, "w", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row, ensure_ascii=False) + "\n")
            f.write(json.dumps({"corpus_wer": mean}) + "\n")
    return {"wer": mean, "n": len(rows)}


# ---------------------------------------------------------------------------
# SIM (speaker cosine similarity)
# ---------------------------------------------------------------------------


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = a / (np.linalg.norm(a) + 1e-8)
    b = b / (np.linalg.norm(b) + 1e-8)
    return float(np.dot(a, b))


def score_sim(
    pairs: Sequence[Tuple[str, str, str]],  # (utt, gen_wav_path, prompt_wav_path)
    embed_fn: Callable[[str], np.ndarray],
    results_path: Optional[str] = None,
) -> Dict[str, float]:
    """Mean speaker cosine similarity gen vs prompt (utils_eval.py:714-753).

    embed_fn: path -> speaker embedding (plug a WavLM-ECAPA model here).
    """
    rows, sims = [], []
    for utt, gen_path, prompt_path in pairs:
        s = cosine_similarity(embed_fn(gen_path), embed_fn(prompt_path))
        sims.append(s)
        rows.append({"utt": utt, "sim": s})
    mean = float(np.mean(sims)) if sims else 0.0
    if results_path:
        with open(results_path, "w", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
            f.write(json.dumps({"mean_sim": mean}) + "\n")
    return {"sim": mean, "n": len(sims)}


# ---------------------------------------------------------------------------
# per-utterance ASR-WER runner + parallel scoring (reference:
# run_asr_wer/run_asr_wer_whisper_large_v3 + mp.Pool in
# eval_seedtts_testset.py:60-75)
# ---------------------------------------------------------------------------


def run_asr_wer_pairs(
    test_set: Sequence[Tuple[str, str, str]],  # (gen_wav, prompt_wav, truth)
    transcribe: Callable[[str], str],
    lang: str = "en",
    mode: str = "whisper_v3",  # "seedtts" (run_asr_wer) | "whisper_v3"
) -> List[Dict]:
    """Transcribe + normalize + per-utt WER rows, reference-exact.

    reference: utils_eval.py:494-560 (seedtts mode) and :634-708
    (whisper_v3 mode, which also reports CER)."""
    rows = []
    for gen_wav, _prompt_wav, truth in test_set:
        hypo = transcribe(gen_wav)
        raw_truth, raw_hypo = truth, hypo
        if mode == "seedtts":
            t, h = normalize_seedtts(truth, hypo, lang)
            row = {"wav": os.path.splitext(os.path.basename(gen_wav))[0],
                   "truth": raw_truth, "hypo": raw_hypo, "wer": jiwer_wer(t, h)}
        else:
            t, h = normalize_whisper_v3(truth, hypo, lang)
            row = {"wav": os.path.splitext(os.path.basename(gen_wav))[0],
                   "truth": raw_truth, "hypo": raw_hypo,
                   "wer": jiwer_wer(t, h), "cer": jiwer_cer(t, h)}
        rows.append(row)
    return rows


def split_test_set(test_set: Sequence, n_jobs: int) -> List[Tuple[int, List]]:
    """Contiguous equal splits, reference semantics (utils_eval.py:455-466:
    wav_per_job = len // n + 1)."""
    per = len(test_set) // n_jobs + 1
    return [(i, list(test_set[i * per : (i + 1) * per])) for i in range(n_jobs)]


def _wer_worker(args):
    rank, sub_set, lang, mode, make_transcriber = args
    transcribe = make_transcriber(rank, lang)
    return run_asr_wer_pairs(sub_set, transcribe, lang=lang, mode=mode)


def run_asr_wer_parallel(
    test_set: Sequence[Tuple[str, str, str]],
    make_transcriber: Callable[[int, str], Callable[[str], str]],
    lang: str = "en",
    mode: str = "whisper_v3",
    n_jobs: int = 1,
) -> List[Dict]:
    """mp.Pool scoring, one ASR model per worker (eval_seedtts_testset.py:60-67).

    make_transcriber(rank, lang) -> transcribe(path) must be picklable (a
    module-level function / functools.partial of one)."""
    splits = split_test_set(test_set, n_jobs)
    job_args = [(rank, sub, lang, mode, make_transcriber) for rank, sub in splits]
    if n_jobs == 1:
        results = [_wer_worker(job_args[0])]
    else:
        import multiprocessing as mp

        with mp.Pool(processes=n_jobs) as pool:
            results = pool.map(_wer_worker, job_args)
    full: List[Dict] = []
    for r in results:
        full.extend(r)
    return full


def write_results_jsonl(rows: List[Dict], metric: str, path: str) -> float:
    """Per-utt jsonl + trailing mean line (eval_seedtts_testset.py:76-85:
    the headline number is the MEAN OF PER-UTTERANCE rates, rounded to 5)."""
    vals = []
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            vals.append(row[metric])
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
        mean = round(float(np.mean(vals)), 5) if vals else 0.0
        f.write(f"\n{metric.upper()}: {mean}\n")
    return mean


# ---------------------------------------------------------------------------
# external model loaders (gated — weights must be local)
# ---------------------------------------------------------------------------


def load_asr_backend(lang: str, backend: Optional[str] = None, ckpt_dir: str = "",
                     device="cuda") -> Callable[[str], str]:
    """ASR transcriber factory matching load_asr_model (utils_eval.py:472-488),
    on `device` (the card unless "cpu"; with no card a CUDA request raises).

    lang=zh -> funasr Paraformer (+ zhconv to simplified); lang=en ->
    faster-whisper large-v3 by default, or backend="hf_whisper" for the
    transformers pipeline. All imports/weights gated with clear errors."""
    from f5e_tts_tpu_torch.utils.device import resolve_device

    if backend is None:
        backend = "funasr" if lang == "zh" else "faster_whisper"
    if backend not in ("funasr", "faster_whisper", "hf_whisper"):
        raise ValueError(f"unknown ASR backend {backend!r}")
    dev = resolve_device(device)

    if backend == "funasr":
        try:
            from funasr import AutoModel
            import zhconv
        except ImportError as e:
            raise RuntimeError(
                "zh WER scoring needs the funasr + zhconv packages and local "
                "paraformer-zh weights (reference utils_eval.py:472-481)") from e
        model = AutoModel(model=os.path.join(ckpt_dir, "paraformer-zh"),
                          disable_update=True, device=str(dev))

        def transcribe(path: str) -> str:
            res = model.generate(input=path, batch_size_s=300, disable_pbar=True)
            return zhconv.convert(res[0]["text"], "zh-cn")

        return transcribe

    if backend == "faster_whisper":
        try:
            from faster_whisper import WhisperModel
        except ImportError as e:
            raise RuntimeError(
                "en WER scoring via faster-whisper needs the faster_whisper "
                "package (reference utils_eval.py:483-487); use "
                "backend='hf_whisper' for the transformers path") from e
        model_size = ckpt_dir if ckpt_dir else "large-v3"
        compute = "float16" if dev.type == "cuda" else "int8"
        model = WhisperModel(model_size, device=dev.type, compute_type=compute,
                             device_index=dev.index or 0)

        def transcribe(path: str) -> str:
            segments, _info = model.transcribe(path, beam_size=5, language="en")
            hypo = ""
            for segment in segments:
                hypo = hypo + " " + segment.text
            return hypo

        return transcribe

    return load_whisper_asr(ckpt_dir, lang=lang, device=dev)


def load_whisper_asr(model_path: str, lang: str = "en", device="cuda") -> Callable[[str], str]:
    """HF Whisper transcription fn (reference uses whisper-large-v3 via
    transformers pipeline, utils_eval.py:472-488) on `device` (the card
    unless "cpu"). Needs local weights."""
    try:
        from transformers import pipeline
    except ImportError as e:
        raise RuntimeError("transformers unavailable for ASR scoring") from e
    if not os.path.exists(model_path):
        raise FileNotFoundError(
            f"ASR weights not found at {model_path}; download whisper-large-v3 "
            "locally to score WER (offline build, no auto-download)")
    from f5e_tts_tpu_torch.utils.device import resolve_device

    asr = pipeline("automatic-speech-recognition", model=model_path,
                   device=resolve_device(device))

    def transcribe(path: str) -> str:
        return asr(path, generate_kwargs={"language": lang})["text"]

    return transcribe


def load_wavlm_xvector(model_path: str, device="cuda") -> Callable[[str], np.ndarray]:
    """Speaker embedder via transformers' WavLMForXVector (local weights), on
    `device` (the card unless "cpu").

    The reference uses WavLM-large + a custom ECAPA-TDNN head
    (eval/ecapa_tdnn.py + utils_eval.py:714-719); for that head use
    eval/ecapa.py: load_wavlm_ecapa and plug either into score_sim's
    embed_fn. This loader is the packaged-head alternative.
    """
    if not os.path.exists(model_path):
        raise FileNotFoundError(
            f"WavLM x-vector weights not found at {model_path} (nothing is downloaded)")
    import torch
    from transformers import WavLMForXVector

    from f5e_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = WavLMForXVector.from_pretrained(model_path).to(dev).eval()

    def embed(path: str) -> np.ndarray:
        from f5e_tts_tpu_torch.infer.audio import read_wav, resample

        wav, sr = read_wav(path)
        wav = resample(wav, sr, 16_000)
        with torch.no_grad():
            out = model(input_values=torch.from_numpy(wav[None]).to(dev))
        return out.embeddings[0].cpu().numpy()

    return embed


def load_utmos(model_path: str, device="cuda") -> Callable[[str], float]:
    """UTMOS strong scorer (the reference loads tarepan/SpeechMOS through
    torch.hub, eval_utmos.py:10-42) from a local checkpoint, on `device`
    (the card unless "cpu"): a plain state dict runs through the port's
    utmos22-strong graph (eval/utmos.py: the wav2vec2 encoder, the BLSTM and
    the head); a torchscript archive runs as it is."""
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"UTMOS weights not found at {model_path} (nothing is downloaded)")
    import torch

    from f5e_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    try:
        sd = torch.load(model_path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        from f5e_tts_tpu_torch.eval.utmos import (UTMOSConfig, make_native_utmos_scorer,
                                                  utmos_from_torch)

        cfg = UTMOSConfig()
        return make_native_utmos_scorer(utmos_from_torch(sd, cfg), cfg, device=dev)
    except (KeyError, RuntimeError, ValueError, AttributeError):
        pass  # a torchscript archive or other naming: run the archive itself

    model = torch.jit.load(model_path, map_location=dev).eval()

    def score(path: str) -> float:
        from f5e_tts_tpu_torch.infer.audio import read_wav

        wav, sr = read_wav(path)
        with torch.no_grad():
            return float(model(torch.from_numpy(wav[None]).to(dev), sr))

    return score


def score_utmos(wav_paths: Sequence[str], utmos_fn: Callable[[str], float],
                results_path: Optional[str] = None) -> Dict[str, float]:
    rows = [{"wav": os.path.basename(p), "utmos": utmos_fn(p)} for p in wav_paths]
    mean = float(np.mean([r["utmos"] for r in rows])) if rows else 0.0
    if results_path:
        with open(results_path, "w", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
            f.write(json.dumps({"mean_utmos": mean}) + "\n")
    return {"utmos": mean, "n": len(rows)}
