"""The ASR (PPG / WeNet) training data pipeline as generator chains
(counterpart of `f5e_tts_tpu/data/asr_dataset.py`).

reference: src/f5_tts/ppg/wenet/dataset/{dataset,processor}.py: raw or shard
lists -> parse -> tokenize -> filter -> resample -> fbank -> spec_aug ->
shuffle -> sort -> batch -> padding, on the host in numpy. Audio IO and
resampling go through the port's infer/audio.py, the kaldi fbank through its
ops/kaldi.py (on the CPU here), the distortions through its copy of
data/wav_augment.py. Batches pad the frames to a multiple of `len_multiple`
(the reference pads to the batch's longest). speed_perturb plays the sox
"speed" effect back with the polyphase resampler instead of sox's rate
converter (sox is absent), as the JAX package does. The shuffles take a
`random.Random` and the distortion a numpy generator seeded from it, so a
seed gives the JAX pipeline's draws.
"""

from __future__ import annotations

import json
import random as _random
import tarfile
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------


def read_lists(list_file: str) -> List[Dict]:
    """Each line is one sample (raw: json) or one shard path (shard mode)."""
    out = []
    with open(list_file, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append({"src": line})
    return out


def parse_raw(data: Iterable[Dict]) -> Iterator[Dict]:
    """json lines {key, wav, txt[, start, end]} -> {key, wav, sample_rate, txt}
    (processor.py:139-177). Unreadable files are skipped with a warning."""
    from f5e_tts_tpu_torch.infer.audio import read_wav

    for sample in data:
        obj = json.loads(sample["src"])
        try:
            wav, sr = read_wav(obj["wav"])
            if "start" in obj:
                s = int(obj["start"] * sr)
                e = int(obj["end"] * sr)
                wav = wav[s:e]
            yield dict(key=obj["key"], txt=obj["txt"],
                       wav=np.asarray(wav, np.float32), sample_rate=sr)
        except Exception:  # noqa: BLE001
            import logging

            logging.warning("Failed to read %s", obj.get("wav"))


def tar_shards(data: Iterable[Dict]) -> Iterator[Dict]:
    """Shard mode: each src is a tar whose members pair {prefix}.wav /
    {prefix}.txt (processor.py:67-136)."""
    import io
    import wave as wavmod

    for sample in data:
        with tarfile.open(sample["src"], "r:*") as tf:
            groups: Dict[str, Dict] = {}
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                name = member.name
                prefix, dot, ext = name.rpartition(".")
                buf = tf.extractfile(member).read()
                g = groups.setdefault(prefix, {"key": prefix})
                if ext == "txt":
                    g["txt"] = buf.decode("utf-8").strip()
                elif ext in ("wav",):
                    with wavmod.open(io.BytesIO(buf), "rb") as w:
                        sr = w.getframerate()
                        n = w.getnframes()
                        pcm = np.frombuffer(w.readframes(n), np.int16)
                        if w.getnchannels() > 1:
                            pcm = pcm.reshape(-1, w.getnchannels()).mean(axis=1)
                    g["wav"] = (pcm.astype(np.float32) / 32768.0)
                    g["sample_rate"] = sr
            for g in groups.values():
                if "wav" in g and "txt" in g:
                    yield g


# ---------------------------------------------------------------------------
# per-sample ops
# ---------------------------------------------------------------------------


def tokenize(data: Iterable[Dict], symbol_table: Dict[str, int],
             split_with_space: bool = False, unk: str = "<unk>") -> Iterator[Dict]:
    """Char-level tokenization (processor.py:477-537 without the BPE path)."""
    for sample in data:
        txt = sample["txt"]
        parts = txt.split() if split_with_space else list(txt.replace(" ", ""))
        label = [symbol_table[p] if p in symbol_table
                 else symbol_table.get(unk, 0) for p in parts]
        sample = dict(sample)
        sample["tokens"] = parts
        sample["label"] = label
        yield sample


def filter_samples(data: Iterable[Dict], max_length: int = 10240,
                   min_length: int = 10, token_max_length: int = 200,
                   token_min_length: int = 1,
                   min_output_input_ratio: float = 0.0005,
                   max_output_input_ratio: float = 1.0) -> Iterator[Dict]:
    """Length/ratio filters at 10 ms frames (processor.py:180-228)."""
    for sample in data:
        num_frames = len(sample["wav"]) / sample["sample_rate"] * 100
        if num_frames < min_length or num_frames > max_length:
            continue
        n_tok = len(sample["label"])
        if n_tok < token_min_length or n_tok > token_max_length:
            continue
        if num_frames != 0:
            r = n_tok / num_frames
            if r < min_output_input_ratio or r > max_output_input_ratio:
                continue
        yield sample


def resample(data: Iterable[Dict], resample_rate: int = 16000) -> Iterator[Dict]:
    from f5e_tts_tpu_torch.infer.audio import resample as _resample

    for sample in data:
        if sample["sample_rate"] != resample_rate:
            sample = dict(sample)
            sample["wav"] = _resample(sample["wav"], sample["sample_rate"],
                                      resample_rate)
            sample["sample_rate"] = resample_rate
        yield sample


def speed_perturb(data: Iterable[Dict], speeds: Optional[List[float]] = None,
                  rng: Optional[_random.Random] = None) -> Iterator[Dict]:
    """Random tempo change per utterance (processor.py:254-293). The sox
    'speed' effect is resample-playback (pitch+tempo shift by rate r, i.e.
    reinterpret the signal at sr*r then resample back to sr); we do the same
    with a kaiser-windowed polyphase resampler (scipy resample_poly) instead
    of sox's internal rate converter — same semantics, near-identical
    passband, different stopband ripple."""
    from f5e_tts_tpu_torch.infer.audio import resample as _resample

    speeds = speeds or [0.9, 1.0, 1.1]
    rng = rng or _random
    for sample in data:
        speed = rng.choice(speeds)
        if speed != 1.0:
            sample = dict(sample)
            sr = sample["sample_rate"]
            sample["wav"] = _resample(sample["wav"], int(sr * speed), sr)
        yield sample


def wav_distortion(data: Iterable[Dict], distort_type: str = "quad_distortion",
                   distort_conf: Optional[Dict] = None, rate: float = 0.1,
                   prob: float = 0.5, rng=None) -> Iterator[Dict]:
    """Sample-level waveform distortion (wav_distortion.py:267-290) applied
    to a `prob` fraction of utterances."""
    from f5e_tts_tpu_torch.data.wav_augment import distort_wav_conf

    nprng = np.random.default_rng(rng.randrange(1 << 31) if rng else None)
    for sample in data:
        if nprng.uniform() < prob:
            sample["wav"] = distort_wav_conf(
                np.asarray(sample["wav"], np.float32), distort_type,
                distort_conf, rate=rate, rng=nprng)
        yield sample


def compute_fbank(data: Iterable[Dict], num_mel_bins: int = 80,
                  frame_length: int = 25, frame_shift: int = 10,
                  dither: float = 0.0) -> Iterator[Dict]:
    """kaldi fbank with the reference's (1 << 15) scaling (processor.py:328-376,
    feats.py:49-83), through the port's ops/kaldi.py on the CPU. No dither:
    the reference extracts with dither 0 (feats.py:60)."""
    import torch

    from f5e_tts_tpu_torch.ops.kaldi import kaldi_fbank

    del dither
    for sample in data:
        feat = kaldi_fbank(torch.from_numpy(np.asarray(sample["wav"], np.float32)),
                           sample_rate=sample["sample_rate"], frame_length=frame_length,
                           frame_shift=frame_shift, num_mel_bins=num_mel_bins)[0].numpy()
        yield dict(key=sample["key"], label=sample["label"], feat=feat)


def spec_aug(data: Iterable[Dict], num_t_mask: int = 2, num_f_mask: int = 2,
             max_t: int = 50, max_f: int = 10,
             rng: Optional[_random.Random] = None) -> Iterator[Dict]:
    """Time/freq masking (processor.py:540-576)."""
    rng = rng or _random
    for sample in data:
        y = np.array(sample["feat"])
        max_frames, max_freq = y.shape
        for _ in range(num_t_mask):
            start = rng.randint(0, max_frames - 1)
            length = rng.randint(1, max_t)
            y[start : min(max_frames, start + length), :] = 0
        for _ in range(num_f_mask):
            start = rng.randint(0, max_freq - 1)
            length = rng.randint(1, max_f)
            y[:, start : min(max_freq, start + length)] = 0
        sample = dict(sample)
        sample["feat"] = y
        yield sample


# ---------------------------------------------------------------------------
# buffers + batching
# ---------------------------------------------------------------------------


def shuffle(data: Iterable[Dict], shuffle_size: int = 10000,
            rng: Optional[_random.Random] = None) -> Iterator[Dict]:
    rng = rng or _random
    buf: List[Dict] = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= shuffle_size:
            rng.shuffle(buf)
            yield from buf
            buf = []
    rng.shuffle(buf)
    yield from buf


def sort_by_feat_len(data: Iterable[Dict], sort_size: int = 500) -> Iterator[Dict]:
    buf: List[Dict] = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= sort_size:
            buf.sort(key=lambda x: x["feat"].shape[0])
            yield from buf
            buf = []
    buf.sort(key=lambda x: x["feat"].shape[0])
    yield from buf


def batch(data: Iterable[Dict], batch_type: str = "static",
          batch_size: int = 16, max_frames_in_batch: int = 12000) -> Iterator[List[Dict]]:
    """static (fixed count) or dynamic (padded-frame budget) batching
    (processor.py:631-688)."""
    if batch_type == "static":
        buf: List[Dict] = []
        for sample in data:
            buf.append(sample)
            if len(buf) >= batch_size:
                yield buf
                buf = []
        if buf:
            yield buf
    elif batch_type == "dynamic":
        buf = []
        longest = 0
        for sample in data:
            n = sample["feat"].shape[0]
            longest = max(longest, n)
            if longest * (len(buf) + 1) > max_frames_in_batch:
                if buf:
                    yield buf
                buf = [sample]
                longest = n
            else:
                buf.append(sample)
        if buf:
            yield buf
    else:
        raise ValueError(f"unsupported batch type {batch_type!r}")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padding(data: Iterable[List[Dict]], len_multiple: int = 16,
            label_pad: int = -1) -> Iterator[Dict]:
    """Pad each batch (sorted desc by feat length, reference processor.py:
    691-740) to static-friendly shapes. Yields numpy dict batches."""
    for samples in data:
        order = np.argsort([-s["feat"].shape[0] for s in samples])
        samples = [samples[i] for i in order]
        feat_lens = np.asarray([s["feat"].shape[0] for s in samples], np.int32)
        label_lens = np.asarray([len(s["label"]) for s in samples], np.int32)
        t = _round_up(int(feat_lens.max()), len_multiple)
        u = max(int(label_lens.max()), 1)
        mel_dim = samples[0]["feat"].shape[1]
        feats = np.zeros((len(samples), t, mel_dim), np.float32)
        labels = np.full((len(samples), u), label_pad, np.int64)
        for i, s in enumerate(samples):
            feats[i, : feat_lens[i]] = s["feat"]
            labels[i, : label_lens[i]] = s["label"]
        yield dict(keys=[s["key"] for s in samples], feats=feats,
                   feat_lens=feat_lens, labels=labels, label_lens=label_lens)


# ---------------------------------------------------------------------------
# composed dataset
# ---------------------------------------------------------------------------


def asr_data_pipeline(
    list_file: str,
    symbol_table: Dict[str, int],
    *,
    data_type: str = "raw",  # "raw" | "shard"
    conf: Optional[dict] = None,
    training: bool = True,
    seed: int = 777,
) -> Iterator[Dict]:
    """Full chain, wenet Dataset() equivalent (dataset/dataset.py).

    conf keys (all optional): filter, resample_rate, speed_perturb, fbank,
    spec_aug, shuffle, sort, batch (type/size/max_frames), len_multiple.
    """
    conf = conf or {}
    rng = _random.Random(seed)
    data: Iterable[Dict] = read_lists(list_file)
    if training:
        lst = list(data)
        rng.shuffle(lst)
        data = lst
    data = tar_shards(data) if data_type == "shard" else parse_raw(data)
    data = tokenize(data, symbol_table, **conf.get("tokenize", {}))
    data = filter_samples(data, **conf.get("filter", {}))
    data = resample(data, conf.get("resample_rate", 16000))
    if training and conf.get("speed_perturb", False):
        data = speed_perturb(data, rng=rng)
    if training and conf.get("distortion"):
        data = wav_distortion(data, rng=rng, **conf["distortion"])
    data = compute_fbank(data, **conf.get("fbank", {}))
    if training and conf.get("spec_aug", True):
        data = spec_aug(data, rng=rng, **conf.get("spec_aug_conf", {}))
    if training:
        data = shuffle(data, conf.get("shuffle_size", 1500), rng=rng)
        data = sort_by_feat_len(data, conf.get("sort_size", 500))
    bconf = conf.get("batch", {})
    data = batch(data, bconf.get("type", "static"), bconf.get("size", 16),
                 bconf.get("max_frames_in_batch", 12000))
    return padding(data, conf.get("len_multiple", 16))
