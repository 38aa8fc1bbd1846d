"""Inference CLI: TOML config + flag overrides + multi-voice dialogue
(counterpart of `f5e_tts_tpu/infer/cli.py`).

The reference's surface (src/f5_tts/infer/infer_cli.py:34-364): a TOML config
(basic.toml layout) merged with the flags, `[voices.<name>]` tables and
`[voice_name]` tags inside gen_text for dialogue, chunk saving, silence
removal. Checkpoints are local paths; `--model_cfg` is a model YAML
(`config.load_yaml`) used in place of the preset `--model`. `--device`
picks the device (the card by default). `--asr_model` is a local Whisper
directory that transcribes a voice's empty ref_text (infer/transcribe.py).

Usage:
  python -m f5e_tts_tpu_torch.infer.cli -c config.toml
  python -m f5e_tts_tpu_torch.infer.cli -r ref.wav -s "ref text" -t "text to say" -o out
"""

from __future__ import annotations

import argparse
import os
import re
from datetime import datetime


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="f5e-tts-torch_infer-cli",
                                description="F5E-TTS inference on PyTorch/CUDA")
    p.add_argument("-c", "--config", default=None, help="TOML config file")
    p.add_argument("-m", "--model", default=None, help="model preset name")
    p.add_argument("-mc", "--model_cfg", default=None, help="model yaml config path")
    p.add_argument("-p", "--ckpt_file", default=None, help=".safetensors/.pt checkpoint")
    p.add_argument("-v", "--vocab_file", default=None, help="vocab.txt")
    p.add_argument("-r", "--ref_audio", default=None, help="reference wav")
    p.add_argument("-s", "--ref_text", default=None, help="reference transcript")
    p.add_argument("-t", "--gen_text", default=None, help="text to synthesize")
    p.add_argument("-f", "--gen_file", default=None, help="file with text to synthesize")
    p.add_argument("-o", "--output_dir", default=None)
    p.add_argument("-w", "--output_file", default=None)
    p.add_argument("--save_chunk", action="store_true")
    p.add_argument("--remove_silence", action="store_true")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--target_rms", type=float, default=None)
    p.add_argument("--cross_fade_duration", type=float, default=None)
    p.add_argument("--nfe_step", type=int, default=None)
    p.add_argument("--cfg_strength", type=float, default=None)
    p.add_argument("--sway_sampling_coef", type=float, default=None)
    p.add_argument("--speed", type=float, default=None)
    p.add_argument("--fix_duration", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--asr_model", default=None,
                   help="local whisper weights dir for auto-transcribing empty ref_text")
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    return p


def load_config(args) -> dict:
    """The TOML config with the flags given on top of it
    (reference: infer_cli.py:176-211), and the defaults."""
    cfg = {}
    if args.config:
        import tomllib

        with open(args.config, "rb") as f:
            cfg = tomllib.load(f)
    for key in ("model", "model_cfg", "ckpt_file", "vocab_file", "ref_audio", "ref_text",
                "gen_text", "gen_file", "output_dir", "output_file", "vocoder_local_path",
                "target_rms", "cross_fade_duration", "nfe_step", "cfg_strength",
                "sway_sampling_coef", "speed", "fix_duration", "seed", "asr_model", "device"):
        val = getattr(args, key, None)
        if val is not None:
            cfg[key] = val
    for key in ("save_chunk", "remove_silence"):
        if getattr(args, key):
            cfg[key] = True
    cfg.setdefault("model", "F5TTS_v1_Base")
    cfg.setdefault("device", "cuda")
    cfg.setdefault("output_dir", "tests")
    cfg.setdefault("output_file", f"infer_cli_{datetime.now().strftime('%Y%m%d_%H%M%S')}.wav")
    return cfg


_VOICE_TAG = re.compile(r"(?=\[\w+\])")


def split_voices(gen_text: str) -> list:
    """'[voice] text...' dialogue -> [(voice, text)], untagged text as
    "main" (reference: infer_cli.py:306-324)."""
    out = []
    for chunk in _VOICE_TAG.split(gen_text):
        if not chunk.strip():
            continue
        m = re.match(r"\[(\w+)\]", chunk)
        if m:
            out.append((m.group(1), chunk[m.end():].strip()))
        else:
            out.append(("main", chunk.strip()))
    return out


def main(argv=None) -> str:
    """Synthesize the config's text, voice by voice, into one wav; returns
    its path."""
    import numpy as np

    from f5e_tts_tpu_torch import api
    from f5e_tts_tpu_torch.infer import audio as faudio
    from f5e_tts_tpu_torch.infer.pipeline import preprocess_ref_audio_text
    from f5e_tts_tpu_torch.infer.transcribe import make_cached_transcriber

    cfg = load_config(build_parser().parse_args(argv))

    gen_text = cfg.get("gen_text")
    if cfg.get("gen_file"):
        with open(cfg["gen_file"], encoding="utf-8") as f:
            gen_text = f.read()
    if not gen_text:
        raise SystemExit("no gen_text/gen_file provided")
    if not cfg.get("ref_audio"):
        raise SystemExit("no ref_audio provided")

    tts = api.F5TTS(model=cfg["model"], ckpt_file=cfg.get("ckpt_file", ""),
                    vocab_file=cfg.get("vocab_file", ""),
                    vocoder_local_path=cfg.get("vocoder_local_path"),
                    config_file=cfg.get("model_cfg"), device=cfg["device"])

    # voices: main + named (reference: infer_cli.py:290-305), each preprocessed
    # (silence clip, auto-transcription of an empty ref_text)
    transcriber = make_cached_transcriber(cfg.get("asr_model"), device=cfg["device"])
    voices = {"main": {"ref_audio": cfg["ref_audio"], "ref_text": cfg.get("ref_text", "")}}
    for name, v in cfg.get("voices", {}).items():
        voices[name] = {"ref_audio": v["ref_audio"], "ref_text": v.get("ref_text", "")}
    for name, v in voices.items():
        wav, sr = faudio.read_wav(v["ref_audio"])
        try:
            wav, text = preprocess_ref_audio_text(wav, sr, v["ref_text"], transcribe=transcriber)
        except (RuntimeError, FileNotFoundError) as e:
            raise SystemExit(f"voice [{name}]: {e}")
        v["wav"], v["sr"], v["ref_text"] = wav, sr, text

    chunk_dir = None
    if cfg.get("save_chunk"):
        chunk_dir = os.path.join(cfg["output_dir"], "chunks")
        os.makedirs(chunk_dir, exist_ok=True)
    seed = cfg.get("seed") or 0
    waves, sr = [], tts.target_sample_rate
    for i, (voice, text) in enumerate(split_voices(gen_text)):
        if voice not in voices:
            print(f"warning: voice [{voice}] not defined, using main")
            voice = "main"
        v = voices[voice]
        wav, sr, _ = tts.engine.infer(
            v["wav"], v["sr"], v["ref_text"], text, seed=seed,
            cross_fade_duration=cfg.get("cross_fade_duration", 0.15),
            sway=cfg.get("sway_sampling_coef", -1.0), cfg_strength=cfg.get("cfg_strength", 2.0),
            nfe_steps=cfg.get("nfe_step", 32), speed=cfg.get("speed", 1.0),
            fix_duration=cfg.get("fix_duration"))
        waves.append(wav)
        if chunk_dir is not None:
            faudio.write_wav(os.path.join(chunk_dir, f"{i}_{voice}.wav"), wav, sr)
    tts.seed = seed

    final = np.concatenate(waves) if waves else np.zeros(0, np.float32)
    if cfg.get("remove_silence"):
        final = faudio.remove_silence_edges(final, sr)
    os.makedirs(cfg["output_dir"], exist_ok=True)
    out_path = os.path.join(cfg["output_dir"], cfg["output_file"])
    faudio.write_wav(out_path, final, sr)
    print(f"wrote {out_path} ({len(final) / sr:.2f}s, seed={seed})")
    return out_path


if __name__ == "__main__":
    main()
