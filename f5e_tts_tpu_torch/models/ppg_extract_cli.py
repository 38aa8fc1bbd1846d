"""Offline PPG extraction over a file list (counterpart of
`f5e_tts_tpu/models/ppg_extract_cli.py`).

reference: src/f5_tts/ppg/infer.py (one file) and parallel_infer.py:22-246
(one process per GPU). Each wav is resampled to 16 kHz, zero-padded up to a
multiple of --bucket_seconds, run through `audio_to_ppg` on the extractor's
device (the card unless --device cpu), and saved as `{name}.npy` holding its
true_len PPG rows. One process drives one card: `shard_for_host` keeps the
whole list (sharding across processes waits for the port's parallel layer).

    python -m f5e_tts_tpu_torch.models.ppg_extract_cli --ckpt 33.pt \\
        --config train.yaml --filelist wavs.txt --output_dir ppg_out [--output_type map ...]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List


def shard_for_host(files: List[str]) -> List[str]:
    """This process's share of the list: all of it (one process, one card)."""
    return list(files)


def main(argv=None):
    import numpy as np
    import torch

    from f5e_tts_tpu_torch.infer.audio import read_wav, resample
    from f5e_tts_tpu_torch.models.conformer import load_ppg_extractor

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True, help="wenet ASR checkpoint (33.pt)")
    p.add_argument("--config", required=True, help="train.yaml")
    p.add_argument("--filelist", required=True, help="one wav path per line")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_type", default="ppg", choices=["ppg", "map"])
    p.add_argument("--map_mix_ratio", type=float, default=1.0)
    p.add_argument("--phn_center", default=None)
    p.add_argument("--ce_layer", default=None)
    p.add_argument("--bucket_seconds", type=float, default=2.0,
                   help="each file is padded up to a multiple of this")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    ext = load_ppg_extractor(args.ckpt, args.config, output_type=args.output_type,
                             map_mix_ratio=args.map_mix_ratio, phn_center_path=args.phn_center,
                             ce_layer_path=args.ce_layer, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(args.filelist, "r", encoding="utf-8") as f:
        files = shard_for_host([line.strip() for line in f if line.strip()])

    bucket = int(args.bucket_seconds * 16_000)
    t0 = time.time()
    done = 0
    for path in files:
        wav, sr = read_wav(path)
        wav = resample(wav, sr, 16_000)
        padded = np.zeros(-(-len(wav) // bucket) * bucket, np.float32)
        padded[: len(wav)] = wav
        ppg, true_len = ext.audio_to_ppg(torch.from_numpy(padded[None]),
                                         torch.tensor([len(wav)]))
        out = ppg[0, : int(true_len[0])].cpu().numpy()
        name = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(args.output_dir, f"{name}.npy"), out)
        done += 1
        if done % 100 == 0:
            print(f"{done}/{len(files)} ({done / (time.time() - t0):.1f} files/s)")
    print(f"extracted {done} files in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
