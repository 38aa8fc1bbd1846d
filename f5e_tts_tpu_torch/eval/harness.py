"""Batch evaluation inference: a test set's meta list -> duration-bucketed
prompt batches -> sampler -> vocoder -> one wav an utterance (counterpart of
`f5e_tts_tpu/eval/harness.py`).

reference: src/f5_tts/eval/utils_eval.py:21-219 (meta lists and the
200-bucket duration batching) and src/f5_tts/eval/eval_infer_batch.py:40-227
(the generation loop with its wall clock and RTF). The prompt list is split
between processes by `torch.distributed`'s rank when a process group is up
(the reference's accelerator.split_between_processes).

The noise of a batch is drawn from a generator seeded with `seed` (torch's
stream, not the JAX package's `PRNGKey(seed)`; tests inject the JAX noise
through `draw_noise`).
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from f5e_tts_tpu_torch.infer import audio as faudio
from f5e_tts_tpu_torch.infer.pipeline import pick_bucket
from f5e_tts_tpu_torch.models import cfm as fcfm
from f5e_tts_tpu_torch.ops.mel import mel_spectrogram


def get_seedtts_metainfo(metalst: str) -> List[Tuple[str, str, str, str, str]]:
    """The seed-tts meta.lst: utt|prompt_text|prompt_wav|gt_text[|gt_wav],
    relative paths against the list's directory (utils_eval.py:21-38)."""
    metainfo = []
    base = os.path.dirname(metalst)
    with open(metalst, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) == 5:
                utt, prompt_text, prompt_wav, gt_text, gt_wav = parts
                if not os.path.isabs(gt_wav):
                    gt_wav = os.path.join(base, gt_wav)
            elif len(parts) == 4:
                utt, prompt_text, prompt_wav, gt_text = parts
                gt_wav = os.path.join(base, "wavs", utt + ".wav")
            else:
                continue
            if not os.path.isabs(prompt_wav):
                prompt_wav = os.path.join(base, prompt_wav)
            metainfo.append((utt, prompt_text, prompt_wav, gt_text, gt_wav))
    return metainfo


def get_librispeech_metainfo(metalst: str, librispeech_path: str):
    """The librispeech_pc cross-sentence .lst (utils_eval.py:41-60)."""
    metainfo = []
    with open(metalst, "r", encoding="utf-8") as f:
        for line in f:
            ref_utt, _ref_dur, ref_txt, gen_utt, _gen_dur, gen_txt = line.strip().split("\t")
            rs, rc, _ = ref_utt.split("-")
            gs, gc, _ = gen_utt.split("-")
            ref_wav = os.path.join(librispeech_path, rs, rc, ref_utt + ".flac")
            gen_wav = os.path.join(librispeech_path, gs, gc, gen_utt + ".flac")
            metainfo.append((gen_utt, ref_txt, ref_wav, " " + gen_txt, gen_wav))
    return metainfo


@dataclass
class PromptBatch:
    utts: List[str]
    ref_mels: np.ndarray  # (B, N_ref_max, mel)
    ref_mel_lens: np.ndarray  # (B,)
    total_mel_lens: np.ndarray  # (B,)
    text_ids: np.ndarray  # (B, NT)
    ref_rms: np.ndarray  # (B,)


def log_mel(wav: np.ndarray, mel_cfg) -> np.ndarray:
    """(T,) wav -> (frames, mel) log-mel on the CPU."""
    return mel_spectrogram(torch.from_numpy(np.asarray(wav, np.float32)[None]), mel_cfg)[0].numpy()


def get_inference_prompts(metainfo: Sequence[Tuple[str, str, str, str, str]], tokenize, mel_cfg,
                          *, speed: float = 1.0, target_rms: float = 0.1,
                          use_truth_duration: bool = False, infer_batch_size: int = 1,
                          num_buckets: int = 200, min_secs: float = 3.0, max_secs: float = 40.0,
                          read_audio=None, seed: int = 666) -> List[PromptBatch]:
    """Duration-bucketed, padded prompt batches (utils_eval.py:77-219).
    `read_audio(path) -> (wav float32, sr)` defaults to the wav reader. A
    bucket accumulates total frames and flushes a batch once they reach
    `infer_batch_size` (a frame budget despite its name, utils_eval.py:
    181-198); the batches are shuffled by Python's random with `seed`."""
    read_audio = read_audio or faudio.read_wav
    sr, hop = mel_cfg.target_sample_rate, mel_cfg.hop_length
    min_tokens = int(min_secs * sr // hop)
    max_tokens = int(max_secs * sr // hop)

    buckets: List[List[dict]] = [[] for _ in range(num_buckets)]
    for utt, prompt_text, prompt_wav, gt_text, gt_wav in metainfo:
        wav, wav_sr = read_audio(prompt_wav)
        wav, rms = faudio.normalize_rms(wav, target_rms)
        wav = faudio.resample(wav, wav_sr, sr)
        if prompt_text and len(prompt_text[-1].encode("utf-8")) == 1:
            prompt_text = prompt_text + " "
        ref_mel_len = len(wav) // hop
        if use_truth_duration:
            gt, gt_sr = read_audio(gt_wav)
            total_mel_len = ref_mel_len + int(len(gt) / gt_sr * sr / hop / speed)
        else:
            rt = max(len(prompt_text.encode("utf-8")), 1)
            total_mel_len = ref_mel_len + int(ref_mel_len / rt * len(gt_text.encode("utf-8"))
                                              / speed)
        if not min_tokens <= total_mel_len <= max_tokens:
            continue
        # the reference's bucket index: floor((L - min) / (max - min + 1) * N)
        idx = min(int((total_mel_len - min_tokens) / (max_tokens - min_tokens + 1) * num_buckets),
                  num_buckets - 1)
        buckets[idx].append(dict(utt=utt, ref_mel=log_mel(wav, mel_cfg), ref_mel_len=ref_mel_len,
                                 total_mel_len=total_mel_len, text=prompt_text + gt_text,
                                 rms=rms))

    def flush(group) -> PromptBatch:
        n_ref = max(g["ref_mel"].shape[0] for g in group)
        mels = np.zeros((len(group), n_ref, mel_cfg.n_mel_channels), np.float32)
        for j, g in enumerate(group):
            mels[j, : g["ref_mel"].shape[0]] = g["ref_mel"]
        return PromptBatch(
            utts=[g["utt"] for g in group], ref_mels=mels,
            ref_mel_lens=np.asarray([g["ref_mel_len"] for g in group], np.int32),
            total_mel_lens=np.asarray([g["total_mel_len"] for g in group], np.int32),
            text_ids=tokenize([g["text"] for g in group]),
            ref_rms=np.asarray([g["rms"] for g in group], np.float32))

    batches: List[PromptBatch] = []
    for bucket in buckets:
        accum, group = 0, []
        for g in bucket:
            group.append(g)
            accum += g["total_mel_len"]
            if accum >= infer_batch_size:
                batches.append(flush(group))
                accum, group = 0, []
        if group:
            batches.append(flush(group))
    random.Random(seed).shuffle(batches)
    return batches


def shard_for_host(items: Sequence, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> List:
    """Every process_count-th item from process_index on; the defaults are
    torch.distributed's rank and world size, or 0 and 1 without a group."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (dist.get_rank() if up else 0)
    pc = process_count if process_count is not None else (dist.get_world_size() if up else 1)
    return list(items[pi::pc])


def draw_noise(seed: int, batch: int, length: int, channels: int,
               durations: torch.Tensor) -> torch.Tensor:
    """The sampler's y0 for one batch: a generator seeded with `seed` on the
    durations' device (`cfm.noise_like`), zero past each duration."""
    gen = torch.Generator(device=durations.device).manual_seed(seed)
    return fcfm.noise_like(gen, batch, length, channels, durations)


def run_batch_inference(engine, batches: Sequence[PromptBatch], output_dir: str, *,
                        nfe_steps: int = 32, cfg_strength: float = 2.0, sway: float = -1.0,
                        seed: int = 0, mode: str = "cfg", alpha_spk: float = 1.0,
                        alpha_txt: float = 1.0, alpha_ppg: float = 1.0,
                        target_rms: float = 0.1) -> Dict[str, float]:
    """Generate, vocode and save {utt}.wav for every utterance on the
    engine's device; returns the wall seconds, seconds of audio, RTF and
    batch count (eval_infer_batch.py:184-227). `mode` "cfg" runs the plain
    CFG sampler, "tts" the dual-alpha one, "vc" the voice-conversion one (a
    PPG model; the batch carries no PPG, so it reads zeros). A quiet prompt's
    loudness is restored on its output."""
    os.makedirs(output_dir, exist_ok=True)
    t0 = time.time()
    total_audio_s = 0.0
    sr = engine.mel.target_sample_rate
    dev = engine.device
    with torch.inference_mode():
        for batch in batches:
            bucket = pick_bucket(int(batch.total_mel_lens.max()), engine.buckets)
            inputs = fcfm.prepare_inputs(
                torch.as_tensor(batch.ref_mels[:, :bucket], device=dev),
                torch.as_tensor(batch.ref_mel_lens, device=dev),
                torch.as_tensor(np.minimum(batch.total_mel_lens, bucket), device=dev), bucket,
                text_ids=torch.as_tensor(batch.text_ids, device=dev))
            y0 = draw_noise(seed, len(batch.utts), bucket, inputs.cond.shape[-1], inputs.duration)
            kw = dict(steps=nfe_steps, sway_coef=sway, y0=y0, compute_dtype=engine.compute_dtype,
                      device=dev, state=engine.state)
            if mode == "tts":
                out, _ = fcfm.sample_tts(engine.params, engine.arch, engine.cfm, inputs,
                                         alpha_spk=alpha_spk, alpha_txt=alpha_txt, **kw)
            elif mode == "vc":
                out, _ = fcfm.sample_vc(engine.params, engine.arch, engine.cfm, inputs,
                                        alpha_spk=alpha_spk, alpha_ppg=alpha_ppg, **kw)
            elif mode == "cfg":
                out, _ = fcfm.sample(engine.params, engine.arch, engine.cfm, inputs,
                                     cfg_strength=cfg_strength, **kw)
            else:
                raise ValueError(f"unknown mode {mode!r}")
            out = out.float().cpu().numpy()
            for j, utt in enumerate(batch.utts):
                lo, hi = int(batch.ref_mel_lens[j]), int(batch.total_mel_lens[j])
                wav = engine.decode_mel(out[j, lo:hi])
                if 0 < batch.ref_rms[j] < target_rms:
                    wav = wav * batch.ref_rms[j] / target_rms
                faudio.write_wav(os.path.join(output_dir, f"{utt}.wav"), wav, sr)
                total_audio_s += len(wav) / sr
    dt = time.time() - t0
    return {"wall_s": dt, "audio_s": total_audio_s, "rtf": dt / max(total_audio_s, 1e-9),
            "n_batches": len(batches)}
