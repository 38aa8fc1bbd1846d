"""Lazy Whisper ASR pipeline for reference-audio transcription (counterpart
of `f5e_tts_tpu/infer/transcribe.py`).

reference: src/f5_tts/infer/utils_infer.py:143-179: a module-global ASR
pipeline built on first use, which `preprocess_ref_audio_text` calls when
ref_text is empty; the results are cached by the md5 of the audio
(`infer.pipeline.CachedTranscriber`, :334-348).

Weights are never downloaded: point `model_dir` (or the F5E_ASR_MODEL
environment variable) at a local Whisper directory. The pipeline runs on
the card unless another device is asked for; `transformers` is imported
only when the pipeline is built.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from f5e_tts_tpu_torch.utils.device import resolve_device

_asr_pipe = None
_asr_key = None  # (model_dir, device) of _asr_pipe


def asr_model_dir(model_dir: Optional[str] = None) -> Optional[str]:
    """`model_dir`, else the F5E_ASR_MODEL environment variable, else None."""
    return model_dir or os.environ.get("F5E_ASR_MODEL")


def initialize_asr_pipeline(model_dir: Optional[str] = None, device="cuda"):
    """The transformers ASR pipeline of `model_dir` on `device`, built once
    and kept (utils_infer.py:148-163). Raises RuntimeError when no directory
    is configured and FileNotFoundError when it does not exist."""
    global _asr_pipe, _asr_key
    model_dir = asr_model_dir(model_dir)
    if not model_dir:
        raise RuntimeError(
            "no ASR model configured: pass asr_model=<local whisper dir> or set F5E_ASR_MODEL "
            "(the reference downloads openai/whisper-large-v3-turbo, utils_infer.py:159; "
            "weights are never downloaded here)")
    if not os.path.exists(model_dir):
        raise FileNotFoundError(f"ASR weights not found at {model_dir}")
    dev = resolve_device(device)
    if _asr_pipe is not None and _asr_key == (model_dir, str(dev)):
        return _asr_pipe
    from transformers import pipeline

    _asr_pipe = pipeline("automatic-speech-recognition", model=model_dir, device=dev)
    _asr_key = (model_dir, str(dev))
    return _asr_pipe


def transcribe(ref_audio, language: Optional[str] = None, model_dir: Optional[str] = None,
               device="cuda") -> str:
    """Text of a path or an {"array", "sampling_rate"} input: chunked
    long-form, task "transcribe", the language when given, stripped
    (utils_infer.py:168-179)."""
    pipe = initialize_asr_pipeline(model_dir, device)
    kwargs = {"task": "transcribe"}
    if language:
        kwargs["language"] = language
    return pipe(ref_audio, chunk_length_s=30, generate_kwargs=kwargs,
                return_timestamps=False)["text"].strip()


def make_cached_transcriber(model_dir: Optional[str] = None, language: Optional[str] = None,
                            device="cuda"):
    """A (wav, sr) -> text callable behind the md5 cache, for
    `preprocess_ref_audio_text(transcribe=...)`, or None when no ASR model
    is configured."""
    from f5e_tts_tpu_torch.infer.pipeline import CachedTranscriber

    if not asr_model_dir(model_dir):
        return None

    def fn(wav: np.ndarray, sr: int) -> str:
        return transcribe({"array": np.asarray(wav, np.float32), "sampling_rate": int(sr)},
                          language=language, model_dir=model_dir, device=device)

    return CachedTranscriber(fn)
