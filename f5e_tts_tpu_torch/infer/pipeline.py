"""Inference orchestration (counterpart of `f5e_tts_tpu/infer/pipeline.py`).

Host-side text chunking, byte-ratio duration estimate and cross-fade
stitching in Python; each chunk is one sampler run on a static duration
bucket, then one vocoder decode. (reference: src/f5_tts/infer/
utils_infer.py:367-556)

Not ported yet: the dynamic batcher, AOT engine files, streaming, the
reference-mel cache and the `tts`/`vc` sampler modes.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from f5e_tts_tpu_torch.config import CFMConfig, InferConfig, MelConfig
from f5e_tts_tpu_torch.infer import audio as faudio
from f5e_tts_tpu_torch.models import cfm as fcfm
from f5e_tts_tpu_torch.ops.mel import mel_spectrogram
from f5e_tts_tpu_torch.utils import text as ftext
from f5e_tts_tpu_torch.utils.device import resolve_device


def chunk_text(text: str, max_chars: int = 135) -> List[str]:
    """Split text at sentence boundaries into chunks of <= max_chars UTF-8
    bytes (reference: utils_infer.py:70-97)."""
    chunks: List[str] = []
    current = ""
    for sentence in re.split(r"(?<=[;:,.!?])\s+|(?<=[；：，。！？])", text):
        piece = sentence + " " if sentence and len(sentence[-1].encode("utf-8")) == 1 else sentence
        if len(current.encode("utf-8")) + len(sentence.encode("utf-8")) <= max_chars:
            current += piece
        else:
            if current:
                chunks.append(current.strip())
            current = piece
    if current:
        chunks.append(current.strip())
    return chunks


def estimate_duration(ref_audio_len: int, ref_text: str, gen_text: str, speed: float = 1.0,
                      fix_duration: Optional[float] = None, sample_rate: int = 24_000,
                      hop_length: int = 256) -> int:
    """Total frames from the byte-length ratio (utils_infer.py:464-471)."""
    if fix_duration is not None:
        return int(fix_duration * sample_rate / hop_length)
    if len(gen_text.encode("utf-8")) < 10:
        speed = 0.3  # very short text slows down (utils_infer.py:457-459)
    ref_bytes = max(len(ref_text.encode("utf-8")), 1)
    gen_bytes = len(gen_text.encode("utf-8"))
    return ref_audio_len + int(ref_audio_len / ref_bytes * gen_bytes / speed)


DEFAULT_BUCKETS = (256, 512, 768, 1024, 1280, 1536, 1792, 2048, 3072, 4096)
TEXT_PAD_TO = 32  # text length granularity
# vocoder input length ladder: generated mels are padded with the log-mel
# silence floor to a multiple of this, and the wav is trimmed back
VOCODER_PAD_TO = 128


def pick_bucket(duration: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= duration, capped at the largest."""
    for b in buckets:
        if duration <= b:
            return b
    return buckets[-1]


def cross_fade_stitch(waves: List[np.ndarray], sr: int, cross_fade_duration: float) -> np.ndarray:
    """Linear cross-fade concatenation (utils_infer.py:520-556)."""
    if not waves:
        return np.zeros(0, np.float32)
    if cross_fade_duration <= 0:
        return np.concatenate(waves)
    final = waves[0]
    for nxt in waves[1:]:
        n = min(int(cross_fade_duration * sr), len(final), len(nxt))
        if n <= 0:
            final = np.concatenate([final, nxt])
            continue
        overlap = final[-n:] * np.linspace(1.0, 0.0, n) + nxt[:n] * np.linspace(0.0, 1.0, n)
        final = np.concatenate([final[:-n], overlap, nxt[n:]])
    return final.astype(np.float32)


def preprocess_ref_audio_text(wav: np.ndarray, sr: int, ref_text: str = "", *,
                              transcribe=None, show_info=print) -> Tuple[np.ndarray, str]:
    """Reference preparation (utils_infer.py:293-361): clip to <= 12 s at a
    silence (long, then short, else a hard cut), trim the edge silence,
    transcribe an empty ref_text with the injected `transcribe(wav, sr)`
    callable (raises when there is none), end the text with punctuation."""
    max_samples = 12 * sr
    if len(wav) > max_samples:
        clipped = None
        for thresh_ms in (500, 200):
            pos, step = 6 * sr, int(0.05 * sr)
            while pos < min(len(wav), max_samples):
                if faudio.detect_leading_silence(wav[pos:], sr) >= int(thresh_ms / 1000 * sr):
                    clipped = wav[:pos]
                    break
                pos += step
            if clipped is not None:
                break
        if clipped is None:
            show_info("no proper silence found for clipping, hard cut at 12s")
            clipped = wav[:max_samples]
        else:
            show_info(f"ref audio clipped to {len(clipped) / sr:.1f}s at a silence")
        wav = faudio.remove_silence_edges(clipped, sr)

    if not ref_text.strip():
        if transcribe is None:
            raise RuntimeError("ref_text is empty and no transcriber was provided "
                               "(pass transcribe=callable(wav, sr) -> str)")
        ref_text = transcribe(wav, sr)
        show_info(f"transcribed ref text: {ref_text}")

    ref_text = ref_text.strip()
    if not ref_text.endswith((".", "。")):
        ref_text += ". "
    elif ref_text.endswith("."):
        ref_text += " "
    return wav, ref_text


@dataclass
class TTSEngine:
    """Model params + configs; serves synthesis requests on `device`
    (reference: utils_infer.py load_model -> infer_process, api.py:23-149)."""

    params: dict
    arch: object  # DiTConfig or MMDiTConfig: any backbone models/backbone.py dispatches
    vocab: Optional[dict]
    mel: MelConfig = field(default_factory=MelConfig)
    cfm: CFMConfig = field(default_factory=CFMConfig)
    infer_cfg: InferConfig = field(default_factory=InferConfig)
    tokenizer: str = "byte"
    vocoder_decode: Optional[Callable[[torch.Tensor], np.ndarray]] = None
    compute_dtype: torch.dtype = torch.bfloat16
    buckets: Sequence[int] = DEFAULT_BUCKETS
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        if self.vocab is None:
            return ftext.list_str_to_bytes(list(texts))
        if self.tokenizer == "custom":
            return ftext.list_str_to_idx([list(t) for t in texts], self.vocab)
        raise NotImplementedError(f"tokenizer {self.tokenizer!r} is not ported yet")

    def synthesize_chunk(self, ref_mel: np.ndarray, full_text: str, duration: int, *,
                         seed: int = 0, nfe_steps: Optional[int] = None,
                         cfg_strength: Optional[float] = None,
                         sway: Optional[float] = None) -> np.ndarray:
        """One sampler run on a static bucket -> generated mel (frames, mel).
        ref_mel is (1, ref_frames, mel)."""
        icfg = self.infer_cfg
        nfe = nfe_steps if nfe_steps is not None else icfg.nfe_steps
        cfg = cfg_strength if cfg_strength is not None else icfg.cfg_strength
        sway = sway if sway is not None else icfg.sway_sampling_coef

        ref_frames = ref_mel.shape[1]
        text_ids = self.tokenize([full_text])
        # duration floor: text len + 1 and ref + 1 (cfm.py:403-406)
        duration = min(max(duration, text_ids.shape[1] + 1, ref_frames + 1), icfg.max_duration)
        bucket = pick_bucket(duration, self.buckets)
        duration = min(duration, bucket)
        # the text pads to its own ladder, not to the bucket: the MMDiT's text
        # stream keeps this length, the DiT pads it on to the bucket itself
        nt = min(-(-text_ids.shape[1] // TEXT_PAD_TO) * TEXT_PAD_TO, bucket)
        padded = np.full((1, nt), -1, np.int32)
        padded[0, : min(text_ids.shape[1], nt)] = text_ids[0, :nt]

        dev = self.device
        inputs = fcfm.prepare_inputs(
            torch.as_tensor(np.asarray(ref_mel, np.float32), device=dev),
            torch.tensor([ref_frames], device=dev), torch.tensor([duration], device=dev),
            bucket, text_ids=torch.as_tensor(padded, device=dev))
        gen = torch.Generator(device=dev).manual_seed(seed)
        out, _ = fcfm.sample(self.params, self.arch, self.cfm, inputs, steps=nfe,
                             cfg_strength=cfg, sway_coef=sway, generator=gen,
                             compute_dtype=self.compute_dtype, device=dev)
        return out[0, ref_frames:duration].float().cpu().numpy()

    def decode_mel(self, mel_gen: np.ndarray) -> np.ndarray:
        """Vocoder decode, (L, mel) -> (L * hop,). The mel is padded with the
        log-mel silence floor to the vocoder ladder and the wav trimmed."""
        length = mel_gen.shape[0]
        if self.vocoder_decode is None:
            return np.zeros(length * self.mel.hop_length, np.float32)
        m = np.asarray(mel_gen, np.float32)[None]
        lp = max(-(-max(length, 1) // VOCODER_PAD_TO) * VOCODER_PAD_TO, VOCODER_PAD_TO)
        if lp != length:
            floor = np.full((1, lp - length, m.shape[-1]), np.log(1e-5), np.float32)
            m = np.concatenate([m, floor], axis=1)
        wav = self.vocoder_decode(torch.as_tensor(m, device=self.device))
        return wav[0, : length * self.mel.hop_length]

    def infer(self, ref_wav: np.ndarray, ref_sr: int, ref_text: str, gen_text: str, *,
              seed: int = 0, speed: Optional[float] = None, fix_duration: Optional[float] = None,
              nfe_steps: Optional[int] = None, cfg_strength: Optional[float] = None,
              sway: Optional[float] = None, cross_fade_duration: Optional[float] = None):
        """Normalise the reference -> chunk the text -> sample -> vocode ->
        stitch (utils_infer.py:367-556). Returns (wav, sample_rate, mel)."""
        icfg = self.infer_cfg
        speed = speed if speed is not None else icfg.speed
        xf = cross_fade_duration if cross_fade_duration is not None else icfg.cross_fade_duration
        sr = self.mel.target_sample_rate

        audio, orig_rms = faudio.normalize_rms(ref_wav.astype(np.float32), icfg.target_rms)
        audio = faudio.resample(audio, ref_sr, sr)
        ref_mel = mel_spectrogram(torch.as_tensor(audio[None, :], device=self.device),
                                  self.mel).cpu().numpy()
        ref_audio_len = audio.shape[-1] // self.mel.hop_length

        if ref_text and len(ref_text[-1].encode("utf-8")) == 1:
            ref_text = ref_text + " "
        ref_s = audio.shape[-1] / sr
        # ref-length-derived chunk budget (utils_infer.py:386-388)
        max_chars = (int(len(ref_text.encode("utf-8")) / max(ref_s, 1e-6) * (22 - ref_s))
                     if ref_text else 135)
        waves, mels = [], []
        for i, chunk in enumerate(chunk_text(gen_text, max_chars=max(max_chars, 10))):
            duration = estimate_duration(ref_audio_len, ref_text, chunk, speed, fix_duration,
                                         sr, self.mel.hop_length)
            mel_gen = self.synthesize_chunk(ref_mel, ref_text + chunk, duration, seed=seed + i,
                                            nfe_steps=nfe_steps, cfg_strength=cfg_strength,
                                            sway=sway)
            wav = self.decode_mel(mel_gen)
            if 0 < orig_rms < icfg.target_rms:
                wav = wav * orig_rms / icfg.target_rms
            waves.append(wav)
            mels.append(mel_gen)
        final = cross_fade_stitch(waves, sr, xf)
        mel = np.concatenate(mels, axis=0) if mels else np.zeros((0, self.mel.n_mel_channels))
        return final, sr, mel
