"""The v1 training step's wall time on the card, to compare two trees of the
port on one card: F5TTS_v1_Base at full width and depth (dropout 0.1, bf16
compute), one batch of 8 x 2304 frames from chip_smoke.py's training rows,
through Trainer.train with checkpoints off. Prints one JSON line: the warm
steps' walls and their median, valid frames/s, the device busy of one more
step (torch.profiler: the union of its kernels' intervals) and its kernel
launches, and the peak memory, beside the card's name and power limit.

    python scripts/train_step_wall.py [--root DIR] [--updates 6]

`--root` is the checkout whose port (and chip_smoke.py's helpers) is timed,
this one by default: to compare two commits, unpack the other into a
directory that .gitignore lists and run parent, change, change, parent in
one call.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--updates", type=int, default=6, help="train() updates; the first is warm-up")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from f5e_tts_tpu_torch.config import TrainConfig, preset
    from f5e_tts_tpu_torch.kernels import _build
    from f5e_tts_tpu_torch.train import step as fstep
    from f5e_tts_tpu_torch.train.trainer import Trainer
    from f5e_tts_tpu_torch.utils.text import list_str_to_bytes

    if not torch.cuda.is_available():
        print("train_step_wall: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.build()
    cfg = dataclasses.replace(preset("F5TTS_v1_Base"), tokenizer="byte", vocab_size=256)
    tc = TrainConfig(num_warmup_updates=1, save_dir=str(root / "build" / "step_wall"), seed=0)
    walls = []
    trainer = Trainer(cfg, tc, vocab_size=256, tokenize=list_str_to_bytes, device="cuda",
                      log_fn=lambda metrics, update: walls.append(metrics["step_seconds"]))
    trainer.save_checkpoint = lambda ts, last=False: None
    ts = trainer.init_state(total_updates=args.updates + 1, rng_seed=0)
    cs.seed_modulation_(ts.params, torch.Generator(device="cuda").manual_seed(1))
    ts.ema_params = fstep.tree_map(lambda t: t.detach().clone(), ts.params)
    loader = cs.training_loader(trainer, tc)
    batch = trainer.device_batch(next(iter(loader)))
    frames = int(batch["mel_lens"].sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts, _ = trainer.train(loader, epochs=args.updates, resume=False, max_updates=args.updates)
    peak = torch.cuda.max_memory_allocated()
    warm = walls[1:]

    # one more step, profiled, under its key (or the parent's generator) as
    # train() makes it
    step = trainer.make_step()
    draws = trainer.step_key if hasattr(trainer, "step_key") else trainer.step_generator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(ts, batch, draws(ts))
        torch.cuda.synchronize()
    kernels = cs.device_kernels(prof)
    print(json.dumps({
        "root": str(root), "card": smi, "walls_s": warm, "wall_s": float(np.median(warm)),
        "valid_frames_per_s": frames / float(np.median(warm)),
        "busy_ms": cs.busy_ms(kernels),
        "kernel_launches": len(kernels), "peak_gib": peak / 2**30}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
