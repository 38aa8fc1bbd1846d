"""Dataset + batching for training (the port's copy of
`f5e_tts_tpu/data/dataset.py`; reference: src/f5_tts/model/dataset.py).

- the dataset yields RAW AUDIO + text; the log-mel frontend runs on the card
  inside the training step (`train/trainer.py: loss_with_device_mel`),
- batches are padded to length buckets (a multiple of `len_multiple`
  frames) so the step sees a bounded set of shapes,
- the frame-packed batch sampler reproduces DynamicBatchSampler semantics
  (sort by frame length, pack <= frames_threshold and <= max_samples, seeded
  per-epoch shuffle) — reference dataset.py:232-303.

- with `with_16k_audio`, each item also carries its audio at 16 kHz for the
  PPG extractor of PPG training (reference dataset.py:219-226 yields 16 kHz
  kaldi fbank), and the batch `audio_16k` (B, T16) with `audio_16k_lens`;
- with `preprocessed_mel`, rows carry their log-mel (`mel_spec`) and the
  batch a padded `mel` instead of audio.

Not ported yet: the hub-hosted dataset wrapper and the dataset factory.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from f5e_tts_tpu_torch.config import MelConfig


def frame_len_of(duration_s: float, mel: MelConfig) -> int:
    """duration seconds -> mel frame count (dataset.py get_frame_len semantics)."""
    return int(duration_s * mel.target_sample_rate / mel.hop_length)


class ArrowSpeechDataset:
    """Speech dataset over rows {audio: {array, sampling_rate} | audio_path,
    text[, duration]} yielding {audio, text} (reference: dataset.py:83-228,
    CustomDataset). `rows` is any indexable sequence of such rows: a list in
    memory, or an Arrow table from `from_dir`. `with_16k_audio` adds the
    item's audio at 16 kHz as `audio_16k` (PPG training);
    `preprocessed_mel` reads each row's `mel_spec` (frames-first, or the
    legacy channels-first) and yields {mel, text}."""

    def __init__(self, rows, durations: Optional[Sequence[float]] = None,
                 mel: MelConfig = MelConfig(), preprocessed_mel: bool = False,
                 with_16k_audio: bool = False):
        self.rows = rows
        self.durations = durations
        self.mel = mel
        self.preprocessed_mel = preprocessed_mel
        self.with_16k_audio = with_16k_audio

    @classmethod
    def from_dir(cls, path: str, mel: MelConfig = MelConfig()):
        """data/{name}_{tokenizer}/raw.arrow (or raw/) + duration.json; needs
        the `datasets` package, imported here only."""
        from datasets import Dataset as ArrowDataset
        from datasets import load_from_disk

        if os.path.isdir(os.path.join(path, "raw")):
            rows = load_from_disk(os.path.join(path, "raw"))
        else:
            rows = ArrowDataset.from_file(os.path.join(path, "raw.arrow"))
        durations = None
        dj = os.path.join(path, "duration.json")
        if os.path.exists(dj):
            with open(dj, "r", encoding="utf-8") as f:
                durations = json.load(f)["duration"]
        return cls(rows, durations, mel)

    def __len__(self) -> int:
        return len(self.rows)

    def get_frame_len(self, idx: int) -> int:
        if self.durations is not None:
            return frame_len_of(self.durations[idx], self.mel)
        row = self.rows[idx]
        if "duration" in row:
            return frame_len_of(row["duration"], self.mel)
        audio = row["audio"]
        sr = int(audio.get("sampling_rate", self.mel.target_sample_rate))
        return int(len(audio["array"]) / sr * self.mel.target_sample_rate / self.mel.hop_length)

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        text = row["text"]
        if self.preprocessed_mel:
            mel = np.asarray(row["mel_spec"], np.float32)
            if mel.ndim == 2 and mel.shape[0] == self.mel.n_mel_channels:
                mel = mel.T  # channels-first legacy -> frames-first
            return {"mel": mel, "text": text}
        audio = row["audio"] if "audio" in row else row["audio_path"]
        if isinstance(audio, dict):
            wav = np.asarray(audio["array"], np.float32)
            sr = int(audio.get("sampling_rate", self.mel.target_sample_rate))
        else:
            from f5e_tts_tpu_torch.infer.audio import read_wav

            wav, sr = read_wav(audio)
        from f5e_tts_tpu_torch.infer.audio import resample

        out = {"text": text}
        if self.with_16k_audio:
            out["audio_16k"] = resample(wav, sr, 16_000)
        out["audio"] = resample(wav, sr, self.mel.target_sample_rate)
        return out


def pack_batches(frame_lens: Sequence[int], frames_threshold: int, max_samples: int = 0,
                 min_frames: int = 0, max_frames: int = 10**9) -> List[List[int]]:
    """Sort-by-length frame packing (reference dataset.py:250-281). Items
    longer than the threshold, or outside [min_frames, max_frames], are
    dropped."""
    order = sorted(range(len(frame_lens)), key=lambda i: frame_lens[i])
    batches: List[List[int]] = []
    batch: List[int] = []
    batch_frames = 0
    for idx in order:
        fl = frame_lens[idx]
        if fl < min_frames or fl > max_frames:
            continue
        if batch_frames + fl <= frames_threshold and (max_samples == 0 or len(batch) < max_samples):
            batch.append(idx)
            batch_frames += fl
        else:
            if batch:
                batches.append(batch)
            if fl <= frames_threshold:
                batch = [idx]
                batch_frames = fl
            else:
                batch = []
                batch_frames = 0
    if batch:
        batches.append(batch)
    return batches


@dataclass
class FramePackedSampler:
    """Epoch-shuffled iterator over packed batches (dataset.py:232-303)."""

    batches: List[List[int]]
    seed: Optional[int] = None
    epoch: int = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator[List[int]]:
        if self.seed is None:
            return iter(self.batches)
        rng = np.random.default_rng(self.seed + self.epoch)
        perm = rng.permutation(len(self.batches))
        return iter([self.batches[i] for i in perm])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def collate(items: List[Dict], tokenize, mel: MelConfig, len_multiple: int = 128,
            batch_multiple: int = 1, text_multiple: int = 32) -> Dict[str, np.ndarray]:
    """Pad a packed batch to bucket shapes: {audio (B, T) or mel (B, N, D),
    mel_lens, text_ids (pad -1), text_lens}, and with 16 kHz items
    audio_16k (B, T16, padded to 100 ms multiples) and audio_16k_lens. The
    reference collate (dataset.py:379-418) pads to the exact batch max;
    lengths here round up to multiples so shapes repeat across batches."""
    texts = [it["text"] for it in items]
    ids = tokenize(texts)  # (B, NT) pad -1
    text_lens = np.asarray([int((row >= 0).sum()) for row in ids], np.int32)
    nt = _round_up(max(ids.shape[1], 1), text_multiple)
    ids_p = np.full((len(items), nt), -1, np.int32)
    ids_p[:, : ids.shape[1]] = ids

    b = _round_up(len(items), batch_multiple)
    out: Dict[str, np.ndarray] = {}
    if "mel" in items[0]:
        mel_lens = np.asarray([it["mel"].shape[0] for it in items], np.int32)
        n = _round_up(int(mel_lens.max()), len_multiple)
        mels = np.zeros((b, n, mel.n_mel_channels), np.float32)
        for i, it in enumerate(items):
            mels[i, : it["mel"].shape[0]] = it["mel"]
        out["mel"] = mels
    else:
        hop = mel.hop_length
        audio_lens = np.asarray([len(it["audio"]) for it in items], np.int64)
        mel_lens = (audio_lens // hop + 1).astype(np.int32)
        n = _round_up(int(mel_lens.max()), len_multiple)
        t = n * hop  # audio padded so the mel on the card yields >= n frames
        wavs = np.zeros((b, t), np.float32)
        for i, it in enumerate(items):
            wavs[i, : min(len(it["audio"]), t)] = it["audio"][:t]
        out["audio"] = wavs

    if "audio_16k" in items[0]:
        lens16 = np.asarray([len(it["audio_16k"]) for it in items], np.int64)
        a16 = np.zeros((b, _round_up(int(lens16.max()), 16_000 // 10)), np.float32)
        for i, it in enumerate(items):
            a16[i, : len(it["audio_16k"])] = it["audio_16k"]
        out["audio_16k"] = a16
        lens16_p = np.zeros((b,), np.int32)
        lens16_p[: len(items)] = lens16
        out["audio_16k_lens"] = lens16_p

    mel_lens_p = np.zeros((b,), np.int32)
    mel_lens_p[: len(items)] = np.minimum(mel_lens, n)
    text_lens_p = np.zeros((b,), np.int32)
    text_lens_p[: len(items)] = text_lens
    ids_full = np.full((b, nt), -1, np.int32)
    ids_full[: len(items)] = ids_p[: len(items)]
    out.update({"mel_lens": mel_lens_p, "text_ids": ids_full, "text_lens": text_lens_p})
    return out


class DataLoader:
    """Minimal synchronous loader: sampler -> collate."""

    def __init__(self, dataset: ArrowSpeechDataset, sampler: FramePackedSampler, tokenize,
                 len_multiple: int = 128, text_multiple: int = 32):
        self.dataset = dataset
        self.sampler = sampler
        self.tokenize = tokenize
        self.len_multiple = len_multiple
        self.text_multiple = text_multiple

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        for batch_idx in self.sampler:
            items = [self.dataset[i] for i in batch_idx]
            yield collate(items, self.tokenize, self.dataset.mel, self.len_multiple,
                          text_multiple=self.text_multiple)


def build_loader(dataset: ArrowSpeechDataset, tokenize, frames_threshold: int,
                 max_samples: int = 64, seed: Optional[int] = 666,
                 len_multiple: int = 128, batch_size_type: str = "frame") -> DataLoader:
    """DynamicBatchSampler equivalent (dataset.py:309-373). batch_size_type
    "frame" packs under a frame budget (the reference default); "sample"
    cuts the length-sorted order into batches of `max_samples` (reference
    batch_size_type="sample", trainer.py:283-298). Items outside 0.3-30 s
    are dropped."""
    mel = dataset.mel
    lens = [dataset.get_frame_len(i) for i in range(len(dataset))]
    min_frames, max_frames = frame_len_of(0.3, mel), frame_len_of(30.0, mel)
    if batch_size_type == "sample":
        order = [i for i in sorted(range(len(lens)), key=lambda i: lens[i])
                 if min_frames <= lens[i] <= max_frames]
        bs = max(max_samples, 1)
        batches = [order[i: i + bs] for i in range(0, len(order), bs)]
    else:
        batches = pack_batches(lens, frames_threshold, max_samples, min_frames, max_frames)
    return DataLoader(dataset, FramePackedSampler(batches, seed=seed), tokenize, len_multiple)
