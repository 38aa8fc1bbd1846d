"""Speech editing: infill selected time spans of an utterance with new text
(counterpart of `f5e_tts_tpu/infer/speech_edit.py`).

reference: src/f5_tts/infer/speech_edit.py:140-186. The audio inside the edit
spans is zeroed, a frame-level edit mask (True = keep the original) is built,
and the sampler runs with `prepare_inputs(edit_mask=)`, so the prompt-keep
mask is cond_mask & edit_mask and only the edited spans are generated; every
kept frame of the output is the cond mel (the sampler's prompt overwrite).

Spans are given in seconds (from any aligner), or derived from CTC
posteriors by `token_spans_from_alignment` / `derive_edit_spans`, on the
port's `ctc_forced_align` (models/conformer_train.py), where the reference
runs an external ctc-forced-aligner by hand (speech_edit.py:66-72).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from f5e_tts_tpu_torch.config import MelConfig
from f5e_tts_tpu_torch.infer.audio import resample
from f5e_tts_tpu_torch.infer.pipeline import pick_bucket
from f5e_tts_tpu_torch.models import cfm as fcfm
from f5e_tts_tpu_torch.ops import prng as fprng
from f5e_tts_tpu_torch.ops.mel import mel_spectrogram


def token_spans_from_alignment(logprobs, tokens: Sequence[int], frame_shift_s: float,
                               blank: int = 0) -> List[Tuple[float, float]]:
    """Per-token (start_s, end_s) spans by CTC forced alignment. logprobs:
    (T, V) log-softmax frame posteriors; tokens: the transcript's ids;
    frame_shift_s: the posteriors' frame shift (0.02 for the PPG encoder)."""
    from f5e_tts_tpu_torch.models.conformer_train import ctc_forced_align

    if torch.is_tensor(logprobs):
        logprobs = logprobs.detach().cpu().numpy()
    _, spath = ctc_forced_align(logprobs, tokens, blank, return_states=True)
    spans: List[Optional[List[int]]] = [None] * len(tokens)
    for t, s in enumerate(spath):
        if s % 2 == 1:  # an odd CTC state is label token (s - 1) // 2
            u = (s - 1) // 2
            if spans[u] is None:
                spans[u] = [t, t + 1]
            else:
                spans[u][1] = t + 1
    if any(sp is None for sp in spans):
        raise AssertionError("the alignment skipped a token")
    return [(sp[0] * frame_shift_s, sp[1] * frame_shift_s) for sp in spans]


def derive_edit_spans(logprobs, tokens: Sequence[int], edit_token_ranges: Sequence[Tuple[int, int]],
                      frame_shift_s: float, blank: int = 0) -> List[Tuple[float, float]]:
    """(start_s, end_s) edit spans for token index ranges [i0, i1], both
    ends included: each runs from its first token's start to its last
    token's end (the `parts_to_edit` of `build_edit_mask`)."""
    per_tok = token_spans_from_alignment(logprobs, tokens, frame_shift_s, blank)
    out = []
    for i0, i1 in edit_token_ranges:
        if not 0 <= i0 <= i1 < len(per_tok):
            raise ValueError(f"token range ({i0}, {i1}) outside {len(per_tok)} tokens")
        out.append((per_tok[i0][0], per_tok[i1][1]))
    return out


def build_edit_mask(parts_to_edit: Sequence[Tuple[float, float]], audio_len_samples: int,
                    mel: MelConfig, fix_durations: Optional[Sequence[float]] = None
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(kept audio segments (K, 2) int64 sample ranges, frame edit mask (N,)
    bool, output frames N). Each edited span may be re-timed by
    `fix_durations` (seconds), and the output timeline stretches with it
    (reference: speech_edit.py:140-161)."""
    sr, hop = mel.target_sample_rate, mel.hop_length
    keep_audio, frame_keep = [], []
    cursor = 0
    for i, (start_s, end_s) in enumerate(parts_to_edit):
        start, end = int(start_s * sr), int(end_s * sr)
        part_dur = (end - start) if fix_durations is None else int(fix_durations[i] * sr)
        keep_audio.append((cursor, start))
        frame_keep.append((True, (start - cursor) // hop))
        frame_keep.append((False, part_dur // hop))
        cursor = end
    keep_audio.append((cursor, audio_len_samples))
    frame_keep.append((True, (audio_len_samples - cursor) // hop))

    total_frames = sum(n for _, n in frame_keep)
    mask = np.zeros(total_frames, bool)
    pos = 0
    for keep, n in frame_keep:
        mask[pos: pos + n] = keep
        pos += n
    return np.asarray(keep_audio, np.int64), mask, total_frames


def _runs(mask: np.ndarray) -> List[Tuple[bool, int]]:
    """Run-length encoding of a boolean array: [(value, count), ...]."""
    runs: List[Tuple[bool, int]] = []
    for v in np.asarray(mask, bool):
        if runs and runs[-1][0] == v:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((bool(v), 1))
    return runs


@torch.inference_mode()
def edit_speech(engine, wav: np.ndarray, sr: int, orig_text: str, target_text: str,
                parts_to_edit: Sequence[Tuple[float, float]], *,
                fix_durations: Optional[Sequence[float]] = None, seed: int = 0,
                nfe_steps: Optional[int] = None, cfg_strength: Optional[float] = None,
                sway: Optional[float] = None,
                y0: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, int]:
    """Infill the edit spans of `wav` with `target_text`; returns (wav, sr).

    engine: a `TTSEngine`; the cond mel is computed on its device, the
    sampler is its plain-CFG `cfm.sample` (eager), the decode its
    `decode_mel`. The noise is `y0` when given, else the JAX package's for
    `seed` (`cfm.noise_like` under `prng_key(seed)`).
    `orig_text` is unused, as in the reference (the target text covers the
    whole utterance)."""
    icfg = engine.infer_cfg
    nfe = nfe_steps if nfe_steps is not None else icfg.nfe_steps
    cfg = cfg_strength if cfg_strength is not None else icfg.cfg_strength
    sway = sway if sway is not None else icfg.sway_sampling_coef

    wav = resample(wav.astype(np.float32), sr, engine.mel.target_sample_rate)
    sr, hop = engine.mel.target_sample_rate, engine.mel.hop_length
    keep_segments, frame_mask, total_frames = build_edit_mask(parts_to_edit, len(wav),
                                                              engine.mel, fix_durations)

    # the re-timed audio with zeros in the edited spans (speech_edit.py:147-159)
    out_audio = np.zeros(total_frames * hop, np.float32)
    pos, segments = 0, iter(keep_segments)
    for keep, n in _runs(frame_mask):
        if keep:
            a, _ = next(segments)
            seg = wav[a: a + n * hop]
            out_audio[pos: pos + len(seg)] = seg
        pos += n * hop
    dev = engine.device
    cond_mel = mel_spectrogram(torch.as_tensor(out_audio[None], device=dev), engine.mel)
    n_frames = min(cond_mel.shape[1], total_frames)

    bucket = pick_bucket(n_frames, engine.buckets)
    edit_mask = torch.zeros((1, bucket), dtype=torch.bool, device=dev)
    edit_mask[0, :n_frames] = torch.as_tensor(frame_mask[:n_frames], device=dev)
    frames = torch.tensor([n_frames], device=dev)
    inputs = fcfm.prepare_inputs(cond_mel[:, :bucket], frames, frames, bucket,
                                 text_ids=torch.as_tensor(engine.tokenize([target_text]),
                                                          device=dev),
                                 edit_mask=edit_mask)
    out, _ = fcfm.sample(engine.params, engine.arch, engine.cfm, inputs, steps=nfe,
                         cfg_strength=cfg, sway_coef=sway, key=fprng.prng_key(seed, dev), y0=y0,
                         compute_dtype=engine.compute_dtype, device=dev, state=engine.state)
    return engine.decode_mel(out[0, :n_frames]), sr
