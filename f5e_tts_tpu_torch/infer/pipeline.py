"""Inference orchestration (counterpart of `f5e_tts_tpu/infer/pipeline.py`).

Host-side text chunking, byte-ratio duration estimate and cross-fade
stitching in Python; each chunk is one sampler run on a static duration
bucket, then one vocoder decode. With a vocoder that decodes on the card
(`load_vocoder`'s `decode.device`), the generated mel never leaves it: the
sampler output is sliced there (`slice_gen`) and decoded. A captured
sampler engine (`utils/aot.py`) replays the ODE loop of a matching request
as one CUDA graph. `synthesize_chunk(mode="tts")` runs the dual-alpha TTS
sampler (`cfm.sample_tts`), `mode="vc"` the voice-conversion sampler over a
PPG (`cfm.sample_vc`). `TTSEngine.enable_batching` attaches the serving
batcher (`serving/batcher.py`), which co-batches concurrent requests of its
sampler configuration. (reference: src/f5_tts/infer/utils_infer.py:367-556)
"""

from __future__ import annotations

import hashlib
import re
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.config import CFMConfig, InferConfig, MelConfig
from f5e_tts_tpu_torch.infer import audio as faudio
from f5e_tts_tpu_torch.models import cfm as fcfm
from f5e_tts_tpu_torch.ops.mel import mel_spectrogram
from f5e_tts_tpu_torch.utils import text as ftext
from f5e_tts_tpu_torch.utils.aot import find_sampler_engine
from f5e_tts_tpu_torch.utils.device import resolve_device

# the log-mel silence floor (ops/mel.py clamps at 1e-5): vocoder padding
MEL_FLOOR = float(np.log(1e-5))


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
TEXT_PAD_TO = 32  # default text length granularity (TTSEngine.text_pad_to)
# default vocoder input length ladder (TTSEngine.vocoder_pad_to): generated
# mels are padded with the log-mel silence floor to a multiple of this, and
# the wav is trimmed back
VOCODER_PAD_TO = 128


def pick_bucket(duration: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= duration, capped at the largest."""
    for b in buckets:
        if duration <= b:
            return b
    return buckets[-1]


def slice_gen(out: torch.Tensor, starts: torch.Tensor, gen_lens: torch.Tensor,
              L: int) -> torch.Tensor:
    """Each row's generated window on the device: row i is out[i, starts[i]:
    starts[i] + L] in fp32 (a start past N is clamped to N, as
    `lax.dynamic_slice` clamps it), frames at or past gen_lens[i] replaced by
    the mel silence floor. (B, L, mel); the vocoder reads it with no host
    round trip (reference: f5e_tts_tpu pipeline.py:79-98, slice_gen_core and
    slice_gen in one)."""
    b, n, d = out.shape
    opad = F.pad(out.float(), (0, 0, 0, L))
    idx = starts.to(out.device, torch.long).clamp(0, n)[:, None] + torch.arange(L, device=out.device)
    g = torch.gather(opad, 1, idx[:, :, None].expand(b, L, d))
    keep = torch.arange(L, device=out.device)[None, :] < gen_lens.to(out.device)[:, None]
    return torch.where(keep[:, :, None], g, torch.full((), MEL_FLOOR, device=out.device))


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


class CachedTranscriber:
    """An ASR callable `transcribe(wav, sr) -> str` behind a cache keyed on
    the md5 of the fp32 samples, so a repeated reference skips ASR
    (reference: utils_infer.py:148-179, 334-348)."""

    def __init__(self, transcribe: Callable[[np.ndarray, int], str]):
        self._transcribe = transcribe
        self._cache: dict = {}

    def __call__(self, wav: np.ndarray, sr: int) -> str:
        key = hashlib.md5(np.ascontiguousarray(wav, np.float32).tobytes()).hexdigest()
        if key not in self._cache:
            self._cache[key] = self._transcribe(wav, sr)
        return self._cache[key]


def preprocess_ref_audio_text(wav: np.ndarray, sr: int, ref_text: str = "", *,
                              clip_short: bool = True, transcribe=None,
                              show_info=print) -> Tuple[np.ndarray, str]:
    """Reference preparation (utils_infer.py:293-361): with `clip_short`,
    clip to <= 12 s at a silence (long, then short, else a hard cut) and trim
    the edge silence; transcribe an empty ref_text with the injected
    `transcribe(wav, sr)` callable (raises when there is none); end the text
    with punctuation."""
    max_samples = 12 * sr
    if clip_short and len(wav) > max_samples:
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
    (reference: utils_infer.py load_model -> infer_process, api.py:23-149).

    `engines` holds the captured samplers by name (utils/aot.py:
    `capture_sampler_buckets`), all in the one memory pool `graph_pool`,
    replayed one at a time under `graph_lock`; a request that one of them
    matches replays it, any other runs eagerly. `batcher` is the dynamic
    batcher `enable_batching` attaches (serving/batcher.py)."""

    params: dict
    arch: object  # DiTConfig, UNetTConfig or MMDiTConfig (models/backbone.py dispatches)
    vocab: Optional[dict]
    state: dict = field(default_factory=dict)  # a PPG DiT's BatchNorm running statistics
    mel: MelConfig = field(default_factory=MelConfig)
    cfm: CFMConfig = field(default_factory=CFMConfig)
    infer_cfg: InferConfig = field(default_factory=InferConfig)
    tokenizer: str = "byte"
    # mel (B, L, mel) tensor -> wav; numpy on the host, and with a `.device`
    # attribute the same decode with the wav left on the card
    vocoder_decode: Optional[Callable[[torch.Tensor], np.ndarray]] = None
    compute_dtype: torch.dtype = torch.bfloat16
    buckets: Sequence[int] = DEFAULT_BUCKETS
    device: object = "cuda"
    text_pad_to: int = TEXT_PAD_TO  # text length ladder
    vocoder_pad_to: int = VOCODER_PAD_TO  # vocoder length ladder; 0 decodes the exact length
    use_intersperse: bool = False  # align-loss/cross-mask models intersperse the text
    engines: dict = field(default_factory=dict, repr=False)
    graph_pool: Optional[tuple] = field(default=None, repr=False)
    graph_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    batcher: Optional[object] = field(default=None, repr=False)
    _ref_mel_cache: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        """(B, NT) int32 ids, -1 padded: UTF-8 bytes without a vocab, else the
        characters of each text (char/custom), interspersed when
        `use_intersperse`. The pinyin and g2p-mix front ends are not ported."""
        if self.vocab is None:
            return ftext.list_str_to_bytes(list(texts))
        if self.tokenizer in ("pinyin", "char-level-pinyin", "phone-level-pinyin", "g2p-mix"):
            raise NotImplementedError(f"tokenizer {self.tokenizer!r} is not ported yet "
                                      "(it needs pypinyin or g2p_mix)")
        toks = [list(t) for t in texts]
        if self.use_intersperse:
            toks = ftext.intersperse(toks)
        return ftext.list_str_to_idx(toks, self.vocab)

    def enable_batching(self, max_batch: int = 4, window_ms: float = 20.0,
                        nfe_steps: Optional[int] = None, return_mel: bool = True,
                        wire_dtype: str = "float32", xfer_chunks: int = 1,
                        timesteps: Optional[Sequence[float]] = None,
                        cfg_strength: Optional[float] = None):
        """Attach a `DynamicBatcher` (serving/batcher.py) and return it.
        `infer` sends a chunk through it when its nfe or grid, its cfg and
        its sway are the batcher's (plain CFG); any other request takes the
        direct path. `return_mel=False` resolves (wav, None) and copies no
        mel to the host; `wire_dtype="int16"` rounds the wav to PCM16 on the
        card (the futures still hold float32); `xfer_chunks` > 1 (wav only)
        copies the batch's wavs in row chunks; `cfg_strength` bakes a
        non-default guidance weight (reference: f5e_tts_tpu
        infer/pipeline.py:276-301)."""
        from f5e_tts_tpu_torch.serving.batcher import DynamicBatcher

        self.batcher = DynamicBatcher(self, max_batch=max_batch, window_ms=window_ms,
                                      nfe_steps=nfe_steps, cfg_strength=cfg_strength,
                                      text_pad_to=self.text_pad_to, return_mel=return_mel,
                                      wire_dtype=wire_dtype, xfer_chunks=xfer_chunks,
                                      timesteps=timesteps)
        return self.batcher

    def _aot_sampler(self, nfe: int, bucket: int, timesteps=None, cfg_strength=None,
                     batch: int = 1):
        """The captured engine for (nfe or grid, bucket, variant, batch), or
        None (the JAX engine-file match without the prompt and text lengths,
        which are data here, not shape)."""
        found = find_sampler_engine(self.engines, nfe, bucket, timesteps=timesteps,
                                    cfg_strength=cfg_strength, batch=batch)
        return self.engines[found] if found else None

    def synthesize_chunk(self, ref_mel: np.ndarray, full_text: str, duration: int, *,
                         seed: int = 0, nfe_steps: Optional[int] = None,
                         cfg_strength: Optional[float] = None, sway: Optional[float] = None,
                         mode: str = "tts_cfg", alpha_spk: float = 1.0, alpha_txt: float = 1.0,
                         alpha_ppg: float = 1.0, ppg: Optional[np.ndarray] = None,
                         timesteps: Optional[Sequence[float]] = None, device_out: bool = False):
        """One sampler run on a static bucket -> generated mel (frames, mel).
        ref_mel is (1, ref_frames, mel). `timesteps` is an explicit ODE grid
        (e.g. `pruned_sway_timesteps`) that overrides nfe and sway. `mode`
        "tts" runs the dual-alpha sampler with `alpha_spk` / `alpha_txt` in
        place of `cfg_strength`; "vc" the voice-conversion sampler with
        `alpha_spk` / `alpha_ppg` over `ppg` (1, NP, ppg_dim), the text
        dropped; "cfg" and "tts_cfg" run plain CFG. A PPG model reads `ppg`
        in every mode (zeros when None). A captured engine for this
        configuration is replayed when one matches (plain CFG at the
        engine's default sway, with no `ppg`, as the JAX engines), else the
        sampler runs eagerly; the noise comes from `seed` either way.

        With `device_out` returns (out (1, bucket, mel) on the device,
        ref_frames, duration) and copies nothing to the host."""
        if mode not in ("cfg", "tts_cfg", "tts", "vc"):
            raise ValueError(f"unknown sampler mode {mode!r}")
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
        nt = min(-(-text_ids.shape[1] // self.text_pad_to) * self.text_pad_to, bucket)
        padded = np.full((1, nt), -1, np.int32)
        padded[0, : min(text_ids.shape[1], nt)] = text_ids[0, :nt]

        dev = self.device
        inputs = fcfm.prepare_inputs(
            torch.as_tensor(np.asarray(ref_mel, np.float32), device=dev),
            torch.tensor([ref_frames], device=dev), torch.tensor([duration], device=dev),
            bucket, text_ids=torch.as_tensor(padded, device=dev),
            ppg=None if ppg is None else torch.as_tensor(np.asarray(ppg, np.float32), device=dev))
        gen = torch.Generator(device=dev).manual_seed(seed)
        engine = None
        if mode not in ("tts", "vc") and ppg is None and sway == icfg.sway_sampling_coef:
            engine = self._aot_sampler(nfe, bucket, timesteps=timesteps,
                                       cfg_strength=None if cfg == icfg.cfg_strength else cfg)
        kw = dict(steps=nfe, sway_coef=sway, generator=gen, timesteps=timesteps,
                  compute_dtype=self.compute_dtype, device=dev, state=self.state)
        if engine is not None:
            out = engine.sample(inputs, fcfm.noise_like(gen, 1, bucket, inputs.cond.shape[-1],
                                                        inputs.duration))
        elif mode == "tts":
            out, _ = fcfm.sample_tts(self.params, self.arch, self.cfm, inputs,
                                     alpha_spk=alpha_spk, alpha_txt=alpha_txt, **kw)
        elif mode == "vc":
            out, _ = fcfm.sample_vc(self.params, self.arch, self.cfm, inputs,
                                    alpha_spk=alpha_spk, alpha_ppg=alpha_ppg, **kw)
        else:
            out, _ = fcfm.sample(self.params, self.arch, self.cfm, inputs, cfg_strength=cfg, **kw)
        if device_out:
            return out, ref_frames, duration
        return out[0, ref_frames:duration].float().cpu().numpy()

    def decode_mel(self, mel_gen, device_out: bool = False):
        """Vocoder decode, (L, mel) -> (L * hop,) or (B, L, mel) -> (B, L * hop),
        from a numpy array or a tensor. The mel is padded with the log-mel
        silence floor to the vocoder ladder and the wav trimmed. With
        `device_out`, returns (the untrimmed wav tensor on the card, the trim
        length), which needs a vocoder with `.device`."""
        m = torch.as_tensor(mel_gen, dtype=torch.float32, device=self.device)
        single = m.dim() == 2
        if single:
            m = m[None]
        b, length, d = m.shape
        trim = length * self.mel.hop_length
        if self.vocoder_decode is None:
            if device_out:
                return torch.zeros((b, trim), device=self.device), trim
            w = np.zeros((b, trim), np.float32)
            return w[0] if single else w
        pad = self.vocoder_pad_to
        if pad:
            lp = max(-(-max(length, 1) // pad) * pad, pad)
            if lp != length:
                m = F.pad(m, (0, 0, 0, lp - length), value=MEL_FLOOR)
        if device_out:
            return self.vocoder_decode.device(m), trim
        wav = self.vocoder_decode(m)[:, :trim]
        return wav[0] if single else wav

    def _reference(self, ref_wav: np.ndarray, ref_sr: int):
        """(audio at the model's rate, its rms before normalising, ref mel (1,
        frames, mel) numpy), cached on the md5 of the raw samples and the
        rate: at most 8 entries, the oldest dropped first."""
        key = (hashlib.md5(ref_wav.tobytes()).hexdigest(), ref_sr)
        hit = self._ref_mel_cache.get(key)
        if hit is not None:
            return hit
        audio, orig_rms = faudio.normalize_rms(ref_wav.astype(np.float32),
                                               self.infer_cfg.target_rms)
        audio = faudio.resample(audio, ref_sr, self.mel.target_sample_rate)
        ref_mel = mel_spectrogram(torch.as_tensor(audio[None, :], device=self.device),
                                  self.mel).cpu().numpy()
        if len(self._ref_mel_cache) >= 8:
            self._ref_mel_cache.pop(next(iter(self._ref_mel_cache)))
        self._ref_mel_cache[key] = (audio, orig_rms, ref_mel)
        return audio, orig_rms, ref_mel

    def infer(self, ref_wav: np.ndarray, ref_sr: int, ref_text: str, gen_text: str, *,
              seed: int = 0, speed: Optional[float] = None, fix_duration: Optional[float] = None,
              nfe_steps: Optional[int] = None, cfg_strength: Optional[float] = None,
              sway: Optional[float] = None, cross_fade_duration: Optional[float] = None,
              timesteps: Optional[Sequence[float]] = None, streaming: bool = False,
              chunk_size: int = 2048):
        """Normalise the reference -> chunk the text -> sample -> vocode ->
        stitch (utils_infer.py:367-556). Returns (wav, sample_rate, mel), or
        with `streaming` a generator of (wav piece of <= chunk_size samples,
        sample_rate). `timesteps` is an explicit ODE grid for every chunk.
        With a vocoder that decodes on the card, each chunk's mel is sliced
        and decoded there; the host gets the wav and, after the decode, the mel.
        With a batcher attached, a chunk whose sampler configuration is the
        batcher's is submitted to it and co-batched with concurrent requests
        (its mel is empty when the batcher returns none)."""
        icfg = self.infer_cfg
        speed = speed if speed is not None else icfg.speed
        xf = cross_fade_duration if cross_fade_duration is not None else icfg.cross_fade_duration
        sr, hop = self.mel.target_sample_rate, self.mel.hop_length
        audio, orig_rms, ref_mel = self._reference(ref_wav, ref_sr)
        ref_audio_len = audio.shape[-1] // hop

        if ref_text and len(ref_text[-1].encode("utf-8")) == 1:
            ref_text = ref_text + " "
        ref_s = audio.shape[-1] / sr
        # ref-length-derived chunk budget (utils_infer.py:386-388)
        max_chars = (int(len(ref_text.encode("utf-8")) / max(ref_s, 1e-6) * (22 - ref_s))
                     if ref_text else 135)
        chunks = chunk_text(gen_text, max_chars=max(max_chars, 10))
        dev_decode = getattr(self.vocoder_decode, "device", None)
        # the batcher serves one sampler configuration: a request matches when
        # its grid is the batcher's (a grid subsumes nfe and sway) and, with
        # no grid, its nfe and sway are; its cfg must be the batcher's too
        req_grid = tuple(timesteps) if timesteps is not None else None
        eff_nfe = nfe_steps if nfe_steps is not None else icfg.nfe_steps
        bt = self.batcher
        use_batcher = (bt is not None and req_grid == bt.timesteps
                       and (req_grid is not None or eff_nfe == bt.nfe)
                       and (cfg_strength is None or cfg_strength == bt.cfg_strength)
                       and (req_grid is not None or sway is None or sway == bt.sway))

        def gen():
            for i, chunk in enumerate(chunks):
                duration = estimate_duration(ref_audio_len, ref_text, chunk, speed, fix_duration,
                                             sr, hop)
                kw = dict(seed=seed + i, nfe_steps=nfe_steps, cfg_strength=cfg_strength,
                          sway=sway, timesteps=timesteps)
                if use_batcher:
                    ids = self.tokenize([ref_text + chunk])[0]
                    fut = bt.submit(ref_mel[0], ids[ids >= 0], min(duration, icfg.max_duration),
                                    seed=seed + i)
                    wav, mel_gen = fut.result()
                elif dev_decode is not None:
                    out, rf, dur = self.synthesize_chunk(ref_mel, ref_text + chunk, duration,
                                                         device_out=True, **kw)
                    gl = dur - rf
                    mel_dev = slice_gen(out, torch.tensor([rf], device=self.device),
                                        torch.tensor([gl], device=self.device), gl)
                    wav_dev, trim = self.decode_mel(mel_dev, device_out=True)
                    wav = wav_dev[0, :trim].float().cpu().numpy()
                    mel_gen = mel_dev[0].cpu().numpy()
                else:
                    mel_gen = self.synthesize_chunk(ref_mel, ref_text + chunk, duration, **kw)
                    wav = self.decode_mel(mel_gen)
                if 0 < orig_rms < icfg.target_rms:
                    wav = wav * orig_rms / icfg.target_rms
                yield wav, mel_gen

        if streaming:
            def stream():
                for wav, _ in gen():
                    for j in range(0, len(wav), chunk_size):
                        yield wav[j : j + chunk_size], sr
            return stream()

        waves, mels = [], []
        for wav, mel_gen in gen():
            waves.append(wav)
            if mel_gen is not None:  # a batcher with return_mel=False copies no mel
                mels.append(mel_gen)
        final = cross_fade_stitch(waves, sr, xf)
        mel = np.concatenate(mels, axis=0) if mels else np.zeros((0, self.mel.n_mel_channels))
        return final, sr, mel
