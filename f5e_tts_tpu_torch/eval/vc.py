"""Voice-conversion evaluation prompts: the PPG of the generated region comes
from the prompt's and the ground truth's audio (counterpart of
`f5e_tts_tpu/eval/vc.py`).

reference: src/f5_tts/eval/utils_eval.py:245-393 (get_vc_inference_prompt)
and eval_infer_batch_vc.py: the PPG is extracted from the concatenated
(prompt, ground truth) audio at 16 kHz, and the total duration is that
concatenation's (VC keeps the timing).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from f5e_tts_tpu_torch.eval.harness import PromptBatch, log_mel
from f5e_tts_tpu_torch.infer import audio as faudio


def get_vc_inference_prompts(metainfo: Sequence[Tuple[str, str, str, str, str]], ppg_extractor,
                             mel_cfg, *, target_rms: float = 0.1, infer_batch_size: int = 1,
                             num_buckets: int = 200, min_secs: float = 3.0,
                             max_secs: float = 40.0, read_audio=None,
                             seed: int = 666) -> List[Tuple[PromptBatch, np.ndarray, np.ndarray]]:
    """[(batch, ppg (B, NP, D), ppg_lens (B,))]: prompts bucketed by total
    duration into groups of `infer_batch_size` utterances, the groups
    shuffled by numpy's default_rng(seed); `ppg_extractor` is a
    `models.conformer.PPGExtractor` (its `audio_to_ppg`, on its device)."""
    read_audio = read_audio or faudio.read_wav
    sr, hop = mel_cfg.target_sample_rate, mel_cfg.hop_length
    min_tokens = int(min_secs * sr // hop)
    max_tokens = int(max_secs * sr // hop)
    bucket_w = (max_tokens - min_tokens) / num_buckets

    buckets: List[List[dict]] = [[] for _ in range(num_buckets)]
    for utt, _prompt_text, prompt_wav, _gt_text, gt_wav in metainfo:
        wav, wav_sr = read_audio(prompt_wav)
        wav, rms = faudio.normalize_rms(wav, target_rms)
        wav = faudio.resample(wav, wav_sr, sr)
        gt, gt_sr = read_audio(gt_wav)
        gt = faudio.resample(gt, gt_sr, sr)
        ref_mel_len = len(wav) // hop
        total_mel_len = ref_mel_len + len(gt) // hop
        if not min_tokens <= total_mel_len <= max_tokens:
            continue
        # the PPG of prompt + ground truth at 16 kHz (utils_eval.py:300-330)
        wav16 = faudio.resample(np.concatenate([wav, gt]), sr, 16_000)
        with torch.no_grad():
            ppg, ppg_len = ppg_extractor.audio_to_ppg(
                torch.from_numpy(np.asarray(wav16, np.float32)[None]))
        ppg = ppg[0, : int(ppg_len[0])].float().cpu().numpy()
        idx = min(int((total_mel_len - min_tokens) / bucket_w), num_buckets - 1)
        buckets[idx].append(dict(utt=utt, ref_mel=log_mel(wav, mel_cfg), ref_mel_len=ref_mel_len,
                                 total_mel_len=total_mel_len, ppg=ppg, rms=rms))

    out = []
    for bucket in buckets:
        for i in range(0, len(bucket), infer_batch_size):
            group = bucket[i: i + infer_batch_size]
            n_ref = max(g["ref_mel"].shape[0] for g in group)
            n_ppg = max(g["ppg"].shape[0] for g in group)
            mels = np.zeros((len(group), n_ref, mel_cfg.n_mel_channels), np.float32)
            ppgs = np.zeros((len(group), n_ppg, group[0]["ppg"].shape[-1]), np.float32)
            for j, g in enumerate(group):
                mels[j, : g["ref_mel"].shape[0]] = g["ref_mel"]
                ppgs[j, : g["ppg"].shape[0]] = g["ppg"]
            batch = PromptBatch(
                utts=[g["utt"] for g in group], ref_mels=mels,
                ref_mel_lens=np.asarray([g["ref_mel_len"] for g in group], np.int32),
                total_mel_lens=np.asarray([g["total_mel_len"] for g in group], np.int32),
                text_ids=np.full((len(group), 1), -1, np.int32),
                ref_rms=np.asarray([g["rms"] for g in group], np.float32))
            out.append((batch, ppgs, np.asarray([g["ppg"].shape[0] for g in group], np.int32)))
    np.random.default_rng(seed).shuffle(out)
    return out
