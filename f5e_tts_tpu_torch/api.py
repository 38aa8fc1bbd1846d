"""Python API: the `F5TTS` class (counterpart of `f5e_tts_tpu/api.py`).

Loads a model preset, a checkpoint (or seeded random weights when none is
given) and the Vocos vocoder, and exposes `infer(ref_file, ref_text,
gen_text, ...)`. Runs on the card unless `device="cpu"` is passed.
`capture_buckets` captures the default sampler of those buckets as CUDA
graphs (utils/aot.py); `engine_dir` captures those a JAX engine directory
names. `quantize="int8"` serves the trunk's large matmuls in W8A8
(ops/quant.py); `asr_model` is a local Whisper directory that transcribes an
empty ref_text (infer/transcribe.py).
(reference: src/f5_tts/api.py:23-149)

`model` names a preset of any backbone (`F5TTS_v1_Base`, `F5TTS_Base`,
`F5TTS_Small`, `E2TTS_Base`); `config_file` loads a model YAML instead.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from f5e_tts_tpu_torch.config import CFMConfig, ModelConfig, load_yaml, preset
from f5e_tts_tpu_torch.infer import audio as faudio
from f5e_tts_tpu_torch.infer import transcribe as ftranscribe
from f5e_tts_tpu_torch.ops import prng
from f5e_tts_tpu_torch.infer.pipeline import (CachedTranscriber, TTSEngine,
                                              preprocess_ref_audio_text, slice_gen)
from f5e_tts_tpu_torch.models import backbone as fbb
from f5e_tts_tpu_torch.models.vocos import VocosConfig, init_vocos, vocos_decode, vocos_from_torch
from f5e_tts_tpu_torch.utils import text as ftext
from f5e_tts_tpu_torch.ops.quant import quantize_backbone_params
from f5e_tts_tpu_torch.utils.aot import capture_engine_dir, capture_sampler_buckets
from f5e_tts_tpu_torch.utils.convert import (backbone_from_reference_state_dict,
                                             load_state_dict, to_tensors)
from f5e_tts_tpu_torch.utils.device import resolve_device


def _cast(tree, dtype):
    """Floating-point fp32 leaves -> dtype."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def load_vocoder(vocoder_path: Optional[str] = None, compute_dtype=torch.bfloat16,
                 device="cuda", seed: int = 0):
    """The Vocos decode of `make_vocoder`, weights from a vocos
    .pt/.bin/.safetensors state dict, else seeded random (the reference
    downloads charactr/vocos-mel-24khz)."""
    dev = resolve_device(device)
    cfg = VocosConfig()
    if vocoder_path:
        if vocoder_path.endswith(".safetensors"):
            from safetensors.torch import load_file

            sd = load_file(vocoder_path)
        else:
            sd = torch.load(vocoder_path, map_location="cpu", weights_only=True)
        params = to_tensors(vocos_from_torch(sd, cfg), dev)
    else:
        params = init_vocos(cfg, prng.prng_key(seed), dev)
    return make_vocoder(params, cfg, compute_dtype, dev)


def make_vocoder(params: dict, cfg: VocosConfig, compute_dtype=torch.bfloat16, device="cuda"):
    """A Vocos decode callable over `params` (cast to `compute_dtype`), mel
    (B, N, mel) tensor -> float32 numpy wav; its `.device` decodes the same
    way and leaves the wav tensor on the card (no host copy either way).
    `.device_sliced(out, starts, gen_lens, L)` slices each row's generated
    window out of the sampler output and decodes it in one call, -> (wav,
    sliced mel) on the card (`slice_gen`); `.device_sliced_i16` also rounds
    the wav to PCM16 there (half to even, as `jnp.round`, then clamped to
    [-32768, 32767]), so the copy to the host moves half the bytes
    (reference: f5e_tts_tpu api.py:62-90)."""
    dev = resolve_device(device)
    params = _cast(params, compute_dtype)

    @torch.inference_mode()
    def decode_device(mel: torch.Tensor) -> torch.Tensor:
        return vocos_decode(params, cfg, mel.to(dev, compute_dtype), compute_dtype=compute_dtype)

    def decode(mel: torch.Tensor) -> np.ndarray:
        return decode_device(mel).float().cpu().numpy()

    @torch.inference_mode()
    def decode_sliced(out: torch.Tensor, starts: torch.Tensor, gen_lens: torch.Tensor, L: int):
        mel = slice_gen(out, starts, gen_lens, L)
        return decode_device(mel), mel

    @torch.inference_mode()
    def decode_sliced_i16(out: torch.Tensor, starts: torch.Tensor, gen_lens: torch.Tensor,
                          L: int):
        wav, mel = decode_sliced(out, starts, gen_lens, L)
        return torch.round(wav.float() * 32767.0).clamp(-32768, 32767).to(torch.int16), mel

    decode.device = decode_device
    decode.device_sliced = decode_sliced
    decode.device_sliced_i16 = decode_sliced_i16
    return decode


class F5TTS:
    """reference: api.py:23-149 (same call surface, PyTorch execution)."""

    def __init__(self, model: str = "F5TTS_v1_Base", ckpt_file: str = "", vocab_file: str = "",
                 ode_method: str = "euler", use_ema: bool = True,
                 vocoder_local_path: Optional[str] = None, config_file: Optional[str] = None,
                 compute_dtype=torch.bfloat16, engine_dir: Optional[str] = None,
                 asr_model: Optional[str] = None, model_cfg: Optional[dict] = None,
                 quantize: Optional[str] = None, device="cuda", seed: int = 0,
                 transcribe: Optional[Callable[[np.ndarray, int], str]] = None,
                 capture_buckets: Optional[Sequence[int]] = None):
        """`config_file` is a model YAML (`config.load_yaml`) used in place of
        the preset `model`; `model_cfg` overrides fields of its arch.
        `quantize="int8"` quantizes the backbone after the cast to
        `compute_dtype` (`ops.quant.quantize_backbone_params`); any other
        string raises ValueError. An empty ref_text is transcribed by
        `transcribe(wav, sr) -> str` when given, else by the Whisper pipeline
        of `asr_model` (or F5E_ASR_MODEL), behind a `CachedTranscriber`;
        with neither it raises. `capture_buckets` captures the default
        sampler (NFE 32) of each of those buckets (an MMDiT's at text length
        256, the JAX export's default), `engine_dir` one sampler for each
        (NFE, bucket, grid, guidance) that a JAX engine directory's file
        names list, and for an MMDiT each text length too
        (`utils.aot.capture_engine_dir`: a CUDA graph cannot be read from a
        file); `utils.aot.capture_sampler_buckets(self.engine, ...)`
        captures others. Without `vocab_file`, a config whose tokenizer is
        "g2p-mix" takes the 216-phone inventory (the engine phonemizes
        through `engine._g2p`, the g2p_mix package's G2pMix when None); any
        other tokenizes UTF-8 bytes into `vocab_size` rows."""
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (use 'int8')")
        self.device = resolve_device(device)
        self.asr_model = asr_model
        self.model_cfg: ModelConfig = load_yaml(config_file) if config_file else preset(model)
        arch = self.model_cfg.arch
        if model_cfg:
            known = {f.name for f in dataclasses.fields(arch)}
            arch = dataclasses.replace(arch, **{k: v for k, v in model_cfg.items() if k in known})
        self.target_sample_rate = self.model_cfg.mel.target_sample_rate

        if vocab_file:
            vocab, vocab_size = ftext.get_tokenizer(vocab_file, "custom")
            tokenizer = "custom"
        elif self.model_cfg.tokenizer == "g2p-mix":
            vocab, vocab_size = ftext.get_tokenizer("", "g2p-mix")
            tokenizer = "g2p-mix"
        else:
            # no vocab: the engine tokenizes UTF-8 bytes into a table of the
            # config's vocab_size rows, as the JAX API's engine does
            vocab, vocab_size, tokenizer = None, self.model_cfg.vocab_size, "byte"

        if ckpt_file:
            made = to_tensors(backbone_from_reference_state_dict(
                load_state_dict(ckpt_file, use_ema), arch), self.device)
        else:
            made = fbb.init_backbone(arch, vocab_size, prng.prng_key(seed), self.device)
        params, state = fbb.split_state(arch, made)  # a PPG DiT's BatchNorm state stays fp32
        params = fbb.fuse_qkv(_cast(params, compute_dtype), arch)
        if quantize == "int8":
            params = quantize_backbone_params(params, self.model_cfg.backbone)

        self.engine = TTSEngine(
            params=params, state=state, arch=arch, vocab=vocab, mel=self.model_cfg.mel,
            cfm=CFMConfig(ode_method=ode_method), infer_cfg=self.model_cfg.infer,
            tokenizer=tokenizer,
            vocoder_decode=load_vocoder(vocoder_local_path, compute_dtype, self.device, seed),
            compute_dtype=compute_dtype, device=self.device,
            use_intersperse=(arch.codebook.use_align_loss or arch.ppg.use_cross_mask)
            if hasattr(arch, "codebook") else False)
        self._transcriber = CachedTranscriber(transcribe) if transcribe is not None else None
        self.seed: Optional[int] = None
        if capture_buckets:
            capture_sampler_buckets(self.engine, capture_buckets)
        if engine_dir:
            capture_engine_dir(self.engine, engine_dir)

    def transcribe(self, ref_audio, language: Optional[str] = None,
                   asr_model_path: Optional[str] = None) -> str:
        """Text of a reference audio file or {"array", "sampling_rate"} input
        through the Whisper pipeline of `asr_model_path`, the constructor's
        `asr_model` or F5E_ASR_MODEL, on this model's device (reference:
        api.py:87-88)."""
        return ftranscribe.transcribe(ref_audio, language=language,
                                      model_dir=asr_model_path or self.asr_model,
                                      device=self.device)

    def export_wav(self, wav: np.ndarray, file_wave: str, remove_silence: bool = False):
        if remove_silence:
            wav = faudio.remove_silence_edges(wav, self.target_sample_rate)
        faudio.write_wav(file_wave, wav, self.target_sample_rate)

    def export_spectrogram(self, spec: np.ndarray, file_spec: str):
        """Save the (N, mel) log-mel to .npy."""
        np.save(file_spec, spec)

    @torch.inference_mode()
    def infer(self, ref_file: str, ref_text: str, gen_text: str, *, target_rms: float = 0.1,
              cross_fade_duration: float = 0.15, sway_sampling_coef: float = -1.0,
              cfg_strength: float = 2.0, nfe_step: int = 32, speed: float = 1.0,
              fix_duration: Optional[float] = None, remove_silence: bool = False,
              file_wave: Optional[str] = None, file_spec: Optional[str] = None,
              seed: Optional[int] = None, timesteps: Optional[Sequence[float]] = None):
        """Synthesize `gen_text` in the voice of `ref_file`; `timesteps` is an
        explicit ODE grid (e.g. `cfm.pruned_sway_timesteps`) that overrides
        nfe_step and the sway. Returns (wav, sample_rate, generated mel).
        `target_rms` is taken for the reference's call surface and, as in the
        JAX `F5TTS.infer`, does not reach the engine: the loudness target is
        the model config's `InferConfig.target_rms`."""
        if seed is None:
            seed = random.randint(0, 2**31 - 1)
        self.seed = seed
        wav, sr = faudio.read_wav(ref_file)
        if self._transcriber is None:  # the Whisper pipeline, when one is configured by now
            self._transcriber = ftranscribe.make_cached_transcriber(self.asr_model,
                                                                    device=self.device)
        wav, ref_text = preprocess_ref_audio_text(wav, sr, ref_text, transcribe=self._transcriber)
        out, sr, spec = self.engine.infer(
            wav, sr, ref_text, gen_text, seed=seed, speed=speed, fix_duration=fix_duration,
            nfe_steps=nfe_step, cfg_strength=cfg_strength, sway=sway_sampling_coef,
            cross_fade_duration=cross_fade_duration, timesteps=timesteps)
        if file_wave is not None:
            self.export_wav(out, file_wave, remove_silence)
        if file_spec is not None:
            self.export_spectrogram(spec, file_spec)
        return out, sr, spec
