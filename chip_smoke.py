"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every hand-written kernel from f5e_tts_tpu_torch/csrc with nvcc,
   one process per source, all at once.
3. Full-width zero-shot synthesis through the user entry point:
   F5TTS(model="F5TTS_v1_Base", device="cuda") in bf16 with seeded random
   weights, NFE 32, cfg 2, sway -1, a ~5 s seeded reference wav and
   fix_duration so the chunk lands in the 1536 bucket. Checks a finite wav
   with nonzero RMS, that the sampler output equals the cond mel on the
   prompt frames, and that each kernel launched exactly depth x NFE times in
   every run. A warm-up run, then three timed runs (wall time and RTF, the
   median and each), then one run
   under torch.profiler: device time by layer and by kernel, and the
   device's busy share of the timed run's wall time.
4. One phase per forward kernel (K1, K2) at the synthesis shapes: kernel vs
   its plain PyTorch version on the same inputs (bf16 tolerance below),
   kernel, plain and library times, and the least time the card could take.
5. Full-width training through the user entry point: Trainer("F5TTS_v1_Base",
   device="cuda").train(loader, ...) with fp32 master weights, bf16 compute,
   dropout 0.1 and the byte tokenizer, on one batch of 8 seeded speech-like
   clips of 21.9-24.5 s packed by the port's build_loader under the
   19,200-frame budget (8 x N=2304); the mel runs on the card. Four updates
   (a warm-up step, then three timed ones), checked in train()'s log_fn:
   every step launches each of K1, K2, K4 and K5 exactly depth times, gives
   a finite loss and gradient norm and moves the params; the EMA follows
   ema_decay_at. A fixed-draw, dropout-free evaluation of cfm_loss is lower
   after the steps than before; the save cadence and rotation leave the
   expected checkpoints, and model_last loads back equal. Step walls, valid
   frames per second, peak memory, one profiled step, then a resumed
   train() that fast-forwards the loader and repeats that step's loss.
6. Gradient phase: a 2-block Base-width model's cfm_loss and every gradient
   at B=2, N=1024, fixed draws, dropout 0, once through the kernels and once
   with this script swapping the four wrappers for their plain versions:
   loss within 1e-2 relative, each parameter's gradient at cosine >= 0.99.
7. One phase per backward kernel (K4, K5) at the training shapes, as in 4.
8. Prints one JSON line with every kernel, then the device line last.

Exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository. fp32 matmuls and convolutions run with TF32 off
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
False), so the plain versions are full fp32 references.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
import wave
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 outside
# them, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
DEPTH, NFE = 22, 32
# kernel vs plain on unit-scale bf16 inputs: both round the same fp32 values
# to bf16, so they differ by accumulation order and at most ~1 bf16 ulp
ATOL, RTOL = 2e-2, 1e-2
# K4's gradients are small sums of many rounded terms, and the kernel forms
# delta from the bf16 output where the plain version sums P * dP in fp32:
# max |kernel - plain| <= K4_REL * max |plain| for each of dq, dk, dv
K4_REL = 2e-2
TRAIN_CLIPS, TRAIN_N, TRAIN_STEPS = 8, 2304, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fns, iters: int = 24, warmup: int = 3) -> float:
    """Mean device time in ms of one call, from CUDA events around `iters`
    calls cycling through the callables `fns` (one per input set, so inputs
    larger together than the 50 MB L2 are read from memory).

    A sleep kernel holds the stream while the host enqueues the calls, so the
    host's own time per call (Python, checks, launch) is not counted: without
    it a kernel shorter than its wrapper's host time reads as the host time.
    """
    for i in range(warmup):
        fns[i % len(fns)]()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's 1.98 GHz boost clock
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - ref).abs()
    worst = (err - (ATOL + RTOL * ref.abs())).max().item()
    max_abs = err.max().item()
    log(f"[{name}] max|kernel - plain| = {max_abs:.3e} (tolerance {ATOL} + {RTOL}*|plain|)")
    if worst > 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max|diff| {max_abs})")
    return max_abs


def speech_like(seconds: float, sr: int = 24_000, seed: int = 0) -> np.ndarray:
    """A seeded speech-like signal: harmonics of a gliding pitch under a
    syllable-rate envelope, plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t) + 10.0 * seed
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t)) ** 2
    return 0.1 * envelope * voiced + 0.005 * rng.standard_normal(t.size)


def write_reference_wav(path: Path, seconds: float = 5.03, sr: int = 24_000, seed: int = 0) -> None:
    pcm = (np.clip(speech_like(seconds, sr, seed), -1, 1) * 32767).astype(np.int16)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def synthesis_phase(ra, ga) -> dict:
    """Full-width F5TTS.infer; returns the launch counts of the timed run."""
    from f5e_tts_tpu_torch.api import F5TTS
    from f5e_tts_tpu_torch.models import cfm as fcfm

    t0 = time.perf_counter()
    tts = F5TTS(model="F5TTS_v1_Base", device="cuda", compute_dtype=torch.bfloat16, seed=0)
    arch = tts.engine.arch
    assert (arch.dim, arch.depth, arch.heads, arch.dim_head) == (1024, DEPTH, 16, 64), arch
    # AdaLN-zero leaves every block an identity at init; small seeded
    # modulation and output weights make both kernels shape the wav
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tts.engine.params
    for p in [blk["attn_norm"] for blk in params["blocks"]] + [params["norm_out"], params["proj_out"]]:
        p["w"].copy_(0.02 * torch.randn(p["w"].shape, generator=gen, device="cuda"))
    torch.cuda.synchronize()
    log(f"[synthesis] model built in {time.perf_counter() - t0:.1f} s")

    ref = ROOT / "build" / "smoke" / "ref.wav"
    write_reference_wav(ref)
    ref_text = "Some call me nature, others call me mother nature."
    gen_text = "I love the way the light falls across the water early in the morning."
    fix_duration = 15.11  # int(15.11 * 24000 / 256) = 1416 frames -> bucket 1536

    def infer():
        return tts.infer(str(ref), ref_text, gen_text, nfe_step=NFE, cfg_strength=2.0,
                         sway_sampling_coef=-1.0, fix_duration=fix_duration, seed=7)

    captured = []
    sample = fcfm.sample

    def recording_sample(params, arch, cfm, inputs, **kw):
        out = sample(params, arch, cfm, inputs, **kw)
        captured.append((out[0], inputs, kw))
        return out

    fcfm.sample = recording_sample
    walls = []
    try:
        for run in ("warm-up", "timed 1", "timed 2", "timed 3"):
            captured.clear()
            ra.launches = ga.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav, sr, mel = infer()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {"rope_attention": ra.launches, "gated_adaln": ga.launches}
            log(f"[synthesis] {run}: wall {wall:.3f} s, launches {counts}")
            for name, n in counts.items():
                if n != DEPTH * NFE:
                    raise AssertionError(f"{name} launched {n} times, expected {DEPTH} x {NFE}")
            if run != "warm-up":
                walls.append(wall)
    finally:
        fcfm.sample = sample

    if len(captured) != 1:
        raise AssertionError(f"expected one chunk, the sampler ran {len(captured)} times")
    out, inputs, kw = captured[0]
    if tuple(out.shape) != (1, 1536, 100) or kw["steps"] != NFE or kw["cfg_strength"] != 2.0:
        raise AssertionError(f"unexpected sampler call: shape {tuple(out.shape)}, {kw}")
    keep = inputs.cond_mask[:, :, None].expand_as(out)
    if not torch.equal(out[keep], inputs.cond[keep]):
        raise AssertionError("sampler output differs from the cond mel on the prompt frames")
    ref_frames = int(inputs.cond_mask.sum())
    duration = int(inputs.duration[0])
    if not (np.isfinite(wav).all() and np.isfinite(mel).all()):
        raise AssertionError("non-finite wav or mel")
    rms = float(np.sqrt(np.mean(np.square(wav))))
    if rms <= 0:
        raise AssertionError("silent wav")
    audio_s = len(wav) / sr
    log(f"[synthesis] prompt frames {ref_frames} preserved exactly; duration {duration} "
        f"frames in bucket 1536; wav {len(wav)} samples ({audio_s:.3f} s), rms {rms:.4f}")
    wall = float(np.median(walls))
    log(f"[synthesis] one warm synthesis (median of {len(walls)}): wall {wall:.3f} s, "
        f"RTF {wall / audio_s:.5f} (wall / seconds of generated audio); "
        f"RTF of each: {[round(w / audio_s, 5) for w in walls]}")
    profile_run("profile", infer, wall)
    return counts


# kernel-name fragments -> the layer they belong to, first match wins
KERNEL_GROUPS = (("rope_attention_bwd", "K4 rope_attention_bwd"),
                 ("rope_attention", "K1 rope_attention"),
                 ("gated_adaln_bwd", "K5 gated_adaln_bwd"), ("gated_adaln", "K2 gated_adaln"),
                 ("multi_tensor_apply", "optimizer (foreach)"),
                 ("fprop", "convolution"), ("dgrad", "convolution"), ("wgrad", "convolution"),
                 ("conv", "convolution"), ("fft", "fft"),
                 ("gemm", "matmul"), ("nvjet", "matmul"), ("cutlass", "matmul"),
                 ("xmma", "matmul"))


def profile_run(tag: str, fn, wall: float) -> None:
    """Device time of one more run of `fn` by kernel and by layer
    (torch.profiler), and the device's busy share of the unprofiled warm
    wall time `wall`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"[{tag}] torch.profiler saw no device time: busy share not measured")
        return
    groups: dict = {}
    for e in kernels:
        name = e.key.lower()
        group = next((g for frag, g in KERNEL_GROUPS if frag in name), "elementwise and other")
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e.self_device_time_total / 1e3, n + e.count)
    log(f"[{tag}] device busy {busy_ms:.1f} ms of the {wall * 1e3:.1f} ms warm wall: "
        f"busy share {busy_ms / (wall * 1e3):.3f}")
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[{tag}] {group}: {ms:.1f} ms ({ms / busy_ms:.3f} of busy), {n} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x {e.key[:90]}")


def attention_phase(ra, launches: int) -> dict:
    from f5e_tts_tpu_torch.ops.rope import rot_half, rotary_cos_sin_half

    b, n, h, dh = 2, 1536, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((b, n, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    kv_lens = torch.tensor([1416, 1100], dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(dh, n))

    out = ra.rope_attention(q, k, v, kv_lens, cos, sin, h)
    torch.cuda.synchronize()
    ref = ra.rope_attention_plain(q, k, v, kv_lens, cos, sin, h)
    err = check_close("rope_attention", out, ref)

    # one input set: the kernel does ~600 flops per byte, so where its 25 MB
    # of operands come from barely matters
    ms = cuda_ms([lambda: ra.rope_attention(q, k, v, kv_lens, cos, sin, h)])
    plain_ms = cuda_ms([lambda: ra.rope_attention_plain(q, k, v, kv_lens, cos, sin, h)])
    # library yardstick: SDPA on the pre-rotated q/k with a boolean key mask
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    qr = (q.float() * c + rot_half(q.float()) * s).to(torch.bfloat16).transpose(1, 2)
    kr = (k.float() * c + rot_half(k.float()) * s).to(torch.bfloat16).transpose(1, 2)
    vt = v.transpose(1, 2)
    key_mask = (torch.arange(n, device="cuda")[None, :] < kv_lens[:, None])[:, None, None, :]
    library_ms = cuda_ms([lambda: torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vt, attn_mask=key_mask)])

    # least time: the two products over the valid keys (the kernel skips key
    # tiles past kv_len), or the bytes of q, k, v, out, cos, sin, kv_lens
    keys = sum(int(x) if int(x) > 0 else n for x in kv_lens.tolist())
    flops = 4.0 * h * dh * n * keys
    nbytes = 4 * b * n * h * dh * 2 + 2 * n * dh * 4 + b * 4
    return kernel_row("rope_attention", "rope_attention", "f5e_tts_tpu/ops/pallas_attention.py:523",
                      launches, err, ms, plain_ms, flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES,
                      library_ms)


def adaln_phase(ga, launches: int) -> dict:
    b, n, d = 2, 1536, 1024
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, y = (torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    gate, scale, shift = (torch.randn((b, d), generator=gen, device="cuda").to(torch.bfloat16)
                          for _ in range(3))
    new_x, out = ga.gated_adaln(x, y, gate, scale, shift)
    torch.cuda.synchronize()
    ref_x, ref_out = ga.gated_adaln_plain(x, y, gate, scale, shift)
    err = max(check_close("gated_adaln new_x", new_x, ref_x),
              check_close("gated_adaln out", out, ref_out))
    # timed over 4 input sets (~100 MB with outputs, twice the L2): the
    # kernel is bound by memory, and the bound counts device-memory bytes
    sets = [(x, y)] + [tuple(torch.randn((b, n, d), generator=gen, device="cuda")
                             .to(torch.bfloat16) for _ in range(2)) for _ in range(3)]
    ms = cuda_ms([lambda a=a, c=c: ga.gated_adaln(a, c, gate, scale, shift) for a, c in sets])
    plain_ms = cuda_ms([lambda a=a, c=c: ga.gated_adaln_plain(a, c, gate, scale, shift)
                        for a, c in sets])
    # x, y read once; new_x, out written once; ~11 fp32 flops per element
    nbytes = 4 * b * n * d * 2 + 3 * b * d * 2
    flops = 11.0 * b * n * d
    return kernel_row("gated_adaln", "gated_adaln", "f5e_tts_tpu/ops/pallas_norm.py:38", launches,
                      err, ms, plain_ms, flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES, None)


SENTENCES = ("Some call me nature, others call me mother nature.",
             "I love the way the light falls across the water early in the morning.",
             "The quick brown fox jumps over the lazy dog near the quiet river bank.",
             "She sells sea shells by the sea shore, and the shells she sells are surely seashells.")


def training_loader(trainer, tc):
    """A loader over TRAIN_CLIPS seeded speech-like clips of 21.9-24.5 s with
    byte-tokenized transcripts, packed by the port's build_loader under the
    trainer's frame budget into one batch."""
    from f5e_tts_tpu_torch.data import dataset as fdata

    seconds = np.linspace(21.9, 24.5, TRAIN_CLIPS)
    rows = [{"audio": {"array": speech_like(sec, seed=i + 1).astype(np.float32),
                       "sampling_rate": 24_000},
             "text": " ".join(SENTENCES[(i + j) % len(SENTENCES)] for j in range(5)),
             "duration": float(sec)} for i, sec in enumerate(seconds)]
    ds = fdata.ArrowSpeechDataset(rows, durations=[r["duration"] for r in rows],
                                  mel=trainer.model_cfg.mel)
    loader = fdata.build_loader(ds, trainer.tokenize, frames_threshold=tc.batch_size_per_device,
                                max_samples=tc.max_samples, seed=tc.seed)
    batches = list(loader)
    if len(batches) != 1 or batches[0]["audio"].shape != (TRAIN_CLIPS, TRAIN_N * 256):
        raise AssertionError(f"expected one batch of {TRAIN_CLIPS} x {TRAIN_N} frames, got "
                             f"{[b['audio'].shape for b in batches]}")
    return loader


def seed_modulation_(params, gen) -> None:
    """AdaLN-zero leaves every block an identity at init and the output
    projection zero, so no gradient would reach the trunk on the first step;
    small seeded modulation and output weights make every kernel carry one."""
    with torch.no_grad():
        for p in [blk["attn_norm"] for blk in params["blocks"]] + [params["norm_out"],
                                                                    params["proj_out"]]:
            p["w"].copy_(0.02 * torch.randn(p["w"].shape, generator=gen, device=p["w"].device))


def fixed_draws(gen, b: int, n: int, mel_dim: int, k: int):
    """k sets of cfm_loss draws with no condition drop, from `gen`."""
    from f5e_tts_tpu_torch.models.cfm import LossDraws

    one = torch.ones((), device="cuda")
    return [LossDraws(frac=0.7 + 0.3 * torch.rand(b, generator=gen, device="cuda"),
                      span=torch.rand(b, generator=gen, device="cuda"),
                      x0=torch.randn((b, n, mel_dim), generator=gen, device="cuda"),
                      time=torch.rand(b, generator=gen, device="cuda"), u1=one, u2=one)
            for _ in range(k)]


def training_phase(ra, ga) -> dict:
    """Full-width Trainer.train steps; returns the launch counts of the last
    step."""
    from f5e_tts_tpu_torch.config import TrainConfig, preset
    from f5e_tts_tpu_torch.train import step as fstep
    from f5e_tts_tpu_torch.train.trainer import Trainer, loss_with_device_mel
    from f5e_tts_tpu_torch.utils.convert import dit_from_reference_state_dict, load_state_dict
    from f5e_tts_tpu_torch.utils.text import list_str_to_bytes

    t0 = time.perf_counter()
    model_cfg = dataclasses.replace(preset("F5TTS_v1_Base"), tokenizer="byte", vocab_size=256)
    arch = model_cfg.arch
    assert (arch.dim, arch.depth, arch.heads, arch.dim_head, arch.dropout) == (
        1024, DEPTH, 16, 64, 0.1), arch
    save_dir = ROOT / "build" / "smoke" / "ckpts"
    shutil.rmtree(save_dir, ignore_errors=True)
    # the JAX defaults, with the LR warm-up cut to 2 updates so 4 steps move the
    # weights, and a numbered checkpoint every 2 updates of which 1 is kept
    tc = TrainConfig(num_warmup_updates=2, save_per_updates=2, keep_last_n_checkpoints=1,
                     save_dir=str(save_dir), seed=0)

    def make_trainer(log_fn=None):
        return Trainer(model_cfg, tc, vocab_size=256, tokenize=list_str_to_bytes, log_fn=log_fn,
                       device="cuda")

    trainer = make_trainer()
    # the state train() consumes; steps update its tensors in place
    ts = trainer.init_state(total_updates=TRAIN_STEPS, rng_seed=0)
    seed_modulation_(ts.params, torch.Generator(device="cuda").manual_seed(1))
    ts.ema_params = fstep.tree_map(lambda t: t.detach().clone(), ts.params)
    n_params = sum(t.numel() for t in fstep.tree_leaves(ts.params))
    loader = training_loader(trainer, tc)
    batch = trainer.device_batch(next(iter(loader)))
    frames = int(batch["mel_lens"].sum())
    torch.cuda.synchronize()
    log(f"[training] {n_params / 1e6:.1f}M fp32 params, batch audio {tuple(batch['audio'].shape)}"
        f" -> {TRAIN_CLIPS} x {TRAIN_N} frames, {frames} valid, text "
        f"{tuple(batch['text_ids'].shape)}; set up in {time.perf_counter() - t0:.1f} s; "
        f"{shutil.disk_usage(ROOT).free / 2**30:.0f} GiB free on disk")

    draws = fixed_draws(torch.Generator(device="cuda").manual_seed(5), TRAIN_CLIPS, TRAIN_N,
                        arch.mel_dim, 4)

    def evaluate() -> float:
        with torch.no_grad():
            return float(np.mean([float(loss_with_device_mel(
                ts.params, arch, model_cfg.cfm, model_cfg.mel, batch, draws=d,
                compute_dtype=torch.bfloat16, training=False).loss) for d in draws]))

    def read_counts() -> dict:
        counts = {"rope_attention": ra.launches, "rope_attention_bwd": ra.bwd_launches,
                  "gated_adaln": ga.launches, "gated_adaln_bwd": ga.bwd_launches}
        ra.launches = ra.bwd_launches = ga.launches = ga.bwd_launches = 0
        return counts

    eval_before = evaluate()
    leaves, ema = fstep.tree_leaves(ts.params), fstep.tree_leaves(ts.ema_params)
    probe = [0, len(leaves) // 2, len(leaves) - 2]  # time_embed, a mid block, proj_out
    ema_settings = fstep.EMASettings.from_train_cfg(tc)
    seen = {"walls": [], "counts": {}, "before": [leaves[i].detach().clone() for i in probe]}

    def check_step(metrics: dict, update: int) -> None:
        """train()'s log_fn: the counts of this step alone, then reset."""
        counts = seen["counts"] = read_counts()
        wall = metrics["step_seconds"]  # the step ends in a host read of its loss
        log(f"[training] step {len(seen['walls']) + 1}: update {update}, wall {wall:.3f} s, "
            f"loss {metrics['loss']:.5f}, grad norm {metrics['grad_norm']:.4f}, "
            f"launches {counts}")
        if update != len(seen["walls"]) + 1:
            raise AssertionError(f"update {update} after {len(seen['walls']) + 1} steps")
        if any(n != DEPTH for n in counts.values()):
            raise AssertionError(f"expected {DEPTH} launches of each kernel per step: {counts}")
        if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])):
            raise AssertionError(f"non-finite step: {metrics}")
        if any(torch.equal(b, leaves[i]) for b, i in zip(seen["before"], probe)):
            raise AssertionError("a probed parameter did not change")
        seen["before"] = [leaves[i].detach().clone() for i in probe]
        # ema_pytorch: update u calls EMA.update() at step u-1; with update_every 10
        # only u = 1 of these is gated, and it is a hard copy (decay 0 up to u = 101)
        if fstep.ema_decay_at(update, ema_settings) != 0.0:
            raise AssertionError("EMA decay is not 0 during the warm copies")
        if update == 1:
            if not all(torch.equal(e, p) for e, p in zip(ema, leaves)):
                raise AssertionError("EMA is not a hard copy after update 1")
            seen["ema_copy"] = [e.clone() for e in ema]
        elif not all(torch.equal(e, c) for e, c in zip(ema, seen["ema_copy"])):
            raise AssertionError(f"EMA changed at update {update}, an ungated update")
        seen["walls"].append(wall)

    trainer.log_fn = check_step
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    read_counts()
    t1 = time.perf_counter()
    ts, info = trainer.train(loader, epochs=TRAIN_STEPS, resume=False, max_updates=TRAIN_STEPS)
    train_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    if (ts.update, info["updates"], len(seen["walls"])) != (TRAIN_STEPS,) * 3:
        raise AssertionError(f"train() ran {info} over {len(seen['walls'])} logged steps")
    counts = seen["counts"]
    kept = sorted(p.name for p in save_dir.iterdir())
    if kept != [f"model_{TRAIN_STEPS}.meta.json", f"model_{TRAIN_STEPS}.pt", "model_last.meta.json",
                "model_last.pt"]:
        raise AssertionError(f"unexpected checkpoints after the save cadence and rotation: {kept}")
    eval_after = evaluate()
    log(f"[training] fixed-draw eval loss (4 draw sets, no dropout): before {eval_before:.6f}, "
        f"after {eval_after:.6f}")
    if not eval_after < eval_before:
        raise AssertionError("the fixed-draw eval loss did not fall over the steps")
    walls = seen["walls"][1:]  # the first step is the warm-up
    wall = float(np.median(walls))
    log(f"[training] train(): {TRAIN_STEPS} updates in {train_s:.1f} s with checkpoints {kept}; "
        f"one warm step (median of {len(walls)}): wall {wall:.3f} s, "
        f"{frames / wall:.0f} valid frames/s; each: {[round(w, 4) for w in walls]}; "
        f"peak memory {peak / 2**30:.2f} GiB")

    # the checkpoint train() saved last loads back equal, and its reference-
    # layout EMA export re-ingests as the EMA
    t1 = time.perf_counter()
    path = save_dir / "model_last.pt"
    restored = make_trainer().load_checkpoint(ts)
    pairs = [(fstep.tree_leaves(getattr(restored, k)), fstep.tree_leaves(getattr(ts, k)))
             for k in ("params", "ema_params")]
    pairs.append((restored.opt_state.mu + restored.opt_state.nu, ts.opt_state.mu + ts.opt_state.nu))
    if not all(torch.equal(a, b) for got, want in pairs for a, b in zip(got, want)):
        raise AssertionError("the checkpoint did not round-trip")
    if (restored.update, restored.micro, restored.opt_state.count) != (
            ts.update, ts.micro, ts.opt_state.count):
        raise AssertionError("the checkpoint's counters did not round-trip")
    del restored, pairs
    ema_export = dit_from_reference_state_dict(load_state_dict(str(path)), arch)
    if not all(torch.equal(a.cpu(), b.detach().cpu()) for a, b in zip(
            fstep.tree_leaves(ema_export), fstep.tree_leaves(ts.ema_params))):
        raise AssertionError("the reference-layout EMA export does not load back")
    del ema_export
    log(f"[training] checkpoint {path.name} ({path.stat().st_size / 2**30:.2f} GiB) loaded back "
        f"equal (params, EMA, moments, counters, EMA export) in {time.perf_counter() - t1:.1f} s")

    # one more step, profiled: the next update from the same state
    profiled = {}
    step = trainer.make_step()
    profile_run("training profile", lambda: profiled.setdefault(
        "loss", step(ts, batch, trainer.step_generator(ts))[1].loss), wall)

    # resume from model_last: train() fast-forwards the consumed batch and
    # repeats the profiled step's draws on the same state, so the same loss
    resumed = {}
    t1 = time.perf_counter()
    read_counts()
    ts2, info2 = make_trainer(lambda m, u: resumed.update(m, update=u)).train(
        loader, epochs=TRAIN_STEPS + 1, resume=True, max_updates=TRAIN_STEPS + 1)
    counts2 = read_counts()
    log(f"[training] resumed train(): {info2['updates']} update to {ts2.update} in "
        f"{time.perf_counter() - t1:.1f} s, loss {resumed['loss']:.6f} (the profiled step: "
        f"{profiled['loss']:.6f}), launches {counts2}")
    if (info2["updates"], ts2.update, resumed["update"]) != (1, TRAIN_STEPS + 1, TRAIN_STEPS + 1):
        raise AssertionError(f"the resumed run did not take exactly the next update: {info2}")
    if any(n != DEPTH for n in counts2.values()):
        raise AssertionError(f"expected {DEPTH} launches of each kernel in the resumed step")
    if not abs(resumed["loss"] - profiled["loss"]) <= 1e-5 * abs(profiled["loss"]):
        raise AssertionError("the resumed step's loss differs from the same step run directly")
    del ts2
    shutil.rmtree(save_dir, ignore_errors=True)
    return counts


def gradient_phase(ra, ga) -> None:
    """cfm_loss and all gradients of a 2-block Base-width model through the
    kernels and through their plain versions (swapped in here)."""
    from f5e_tts_tpu_torch.config import CFMConfig, preset
    from f5e_tts_tpu_torch.models import cfm as fcfm
    from f5e_tts_tpu_torch.models.dit import init_dit
    from f5e_tts_tpu_torch.ops.mel import mel_spectrogram
    from f5e_tts_tpu_torch.train import step as fstep
    from f5e_tts_tpu_torch.utils.text import list_str_to_bytes

    b, n = 2, 1024
    arch = dataclasses.replace(preset("F5TTS_v1_Base").arch, depth=2, dropout=0.0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = init_dit(arch, 256, gen, "cuda")
    seed_modulation_(params, gen)
    params = fstep.tree_map(lambda t: t.requires_grad_(True), params)
    wav = torch.from_numpy(np.stack([speech_like(n * 256 / 24_000, seed=s) for s in (11, 12)])
                           ).float().cuda()
    mel = mel_spectrogram(wav, preset("F5TTS_v1_Base").mel)[:, :n]
    mel_lens = torch.tensor([n, 900], device="cuda")
    text = torch.from_numpy(list_str_to_bytes(list(SENTENCES[:2]))).cuda()
    draws = fixed_draws(gen, b, n, arch.mel_dim, 1)[0]

    def loss_and_grads():
        leaves = fstep.tree_leaves(params)
        for p in leaves:
            p.grad = None
        out = fcfm.cfm_loss(params, arch, CFMConfig(), mel=mel, mel_lens=mel_lens, text_ids=text,
                            draws=draws, compute_dtype=torch.bfloat16)
        out.loss.backward()
        return float(out.loss.detach()), [p.grad.detach().clone() for p in leaves]

    counts = (ra.launches, ra.bwd_launches, ga.launches, ga.bwd_launches)
    loss_k, grads_k = loss_and_grads()
    if (ra.launches, ra.bwd_launches, ga.launches, ga.bwd_launches) != tuple(c + 2 for c in counts):
        raise AssertionError("the kernel run did not launch each kernel once per block")
    swapped = {(ra, "rope_attention"): lambda *a, return_stats=False: (
                   (ra.rope_attention_plain(*a), None) if return_stats
                   else ra.rope_attention_plain(*a)),
               (ra, "rope_attention_bwd"): lambda *a: ra.rope_attention_bwd_plain(*a[:8]),
               (ga, "gated_adaln"): ga.gated_adaln_plain,
               (ga, "gated_adaln_bwd"): ga.gated_adaln_bwd_plain}
    saved = {key: getattr(*key) for key in swapped}
    try:
        for (mod, name), fn in swapped.items():
            setattr(mod, name, fn)
        counts = (ra.launches, ra.bwd_launches, ga.launches, ga.bwd_launches)
        loss_p, grads_p = loss_and_grads()
        if (ra.launches, ra.bwd_launches, ga.launches, ga.bwd_launches) != counts:
            raise AssertionError("the plain run launched a kernel")
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = []
    for gk, gp in zip(grads_k, grads_p):
        nk, np_ = gk.double().norm().item(), gp.double().norm().item()
        if nk == np_ == 0.0:
            cos.append(1.0)
        else:
            cos.append((gk.double() * gp.double()).sum().item() / max(nk * np_, 1e-300))
    worst = int(np.argmin(cos))
    log(f"[gradients] 2 blocks, B={b}, N={n}: loss kernels {loss_k:.6f} vs plain {loss_p:.6f} "
        f"(relative difference {rel:.2e}, tolerance 1e-2); gradient cosine over "
        f"{len(cos)} parameters: min {cos[worst]:.6f} (tensor {worst}, shape "
        f"{tuple(grads_k[worst].shape)}), median {float(np.median(cos)):.6f} (tolerance 0.99)")
    if not rel <= 1e-2 or min(cos) < 0.99:
        raise AssertionError("the kernels' loss or gradients disagree with the plain versions")


def check_close_rel(name: str, got: torch.Tensor, ref: torch.Tensor, rel: float) -> float:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err, top = (got - ref).abs().max().item(), ref.abs().max().item()
    log(f"[{name}] max|kernel - plain| = {err:.3e}, max|plain| = {top:.3e} "
        f"(tolerance {rel} * max|plain|)")
    if err > rel * top:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def attention_bwd_phase(ra, launches: dict) -> dict:
    from f5e_tts_tpu_torch.ops.rope import rot_half, rotary_cos_sin_half

    b, n, h, dh = TRAIN_CLIPS, TRAIN_N, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(4)
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(dh, n))

    def operands(batch, lens):
        # q, k, v as column slices of the fused to_qkv output, as in training
        qkv = torch.randn((batch, n, 3 * h * dh), generator=gen, device="cuda").bfloat16()
        q, k, v = (t.unflatten(-1, (h, dh)) for t in qkv.chunk(3, dim=-1))
        g = torch.randn((batch, n, h, dh), generator=gen, device="cuda").bfloat16()
        kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out, stats = ra.rope_attention(q, k, v, kv, cos, sin, h, return_stats=True)
        return q, k, v, kv, g, out, stats

    err = 0.0
    for tag, batch, lens in (("ragged", 2, (n, 1337)), ("training", b, (n,) * b)):
        q, k, v, kv, g, out, stats = operands(batch, lens)
        got = ra.rope_attention_bwd(q, k, v, kv, cos, sin, g, h, out, stats)
        torch.cuda.synchronize()
        ref = ra.rope_attention_bwd_plain(q, k, v, kv, cos, sin, g, h)
        for name, x, y in zip(("dq", "dk", "dv"), got, ref):
            err = max(err, check_close_rel(f"rope_attention_bwd {tag} {name}", x, y, K4_REL))
        del got, ref
        torch.cuda.empty_cache()

    ms = cuda_ms([lambda: ra.rope_attention_bwd(q, k, v, kv, cos, sin, g, h, out, stats)], iters=8)
    plain_ms = cuda_ms([lambda: ra.rope_attention_bwd_plain(q, k, v, kv, cos, sin, g, h)],
                       iters=4, warmup=1)
    torch.cuda.empty_cache()
    # library yardstick: the backward of SDPA (every key valid here) on the
    # pre-rotated q/k, through autograd
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    qr, kr = ((t.float() * c + rot_half(t.float()) * s).bfloat16().transpose(1, 2).detach()
              .requires_grad_() for t in (q, k))
    vt = v.transpose(1, 2).detach().requires_grad_()
    o = torch.nn.functional.scaled_dot_product_attention(qr, kr, vt)
    gt = g.transpose(1, 2)
    library_ms = cuda_ms([lambda: torch.autograd.grad(o, (qr, kr, vt), gt, retain_graph=True)],
                         iters=8)

    # least time: the five N x N x dh products over the valid keys, or the
    # bytes of q, k, v, g, dq, dk, dv, cos, sin, kv_lens
    keys = sum(int(x) if int(x) > 0 else n for x in kv.tolist())
    flops = 10.0 * h * dh * n * keys
    nbytes = 7 * b * n * h * dh * 2 + 2 * n * dh * 4 + b * 4
    return kernel_row("rope_attention_bwd", "rope_attention",
                      "f5e_tts_tpu/ops/pallas_attention.py:567", launches, err, ms, plain_ms,
                      flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES, library_ms)


def adaln_bwd_phase(ga, launches: dict) -> dict:
    b, n, d = TRAIN_CLIPS, TRAIN_N, 1024
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, y, g_newx, g_out = (torch.randn((b, n, d), generator=gen, device="cuda").bfloat16()
                           for _ in range(4))
    # gate and scale as column slices of the (B, 6D) modulation
    mod = torch.randn((b, 6 * d), generator=gen, device="cuda").bfloat16()
    gate, scale = mod[:, 2 * d:3 * d], mod[:, 4 * d:5 * d]
    got = ga.gated_adaln_bwd(x, y, gate, scale, g_newx, g_out)
    torch.cuda.synchronize()
    ref = ga.gated_adaln_bwd_plain(x, y, gate, scale, g_newx, g_out)
    err = max(check_close(f"gated_adaln_bwd {name}", a, r) for name, a, r in
              zip(("dx", "dy", "dgate", "dscale", "dshift"), got, ref))
    # one input set: 4 inputs and 2 outputs of 38 MB each, 4.5x the L2
    ms = cuda_ms([lambda: ga.gated_adaln_bwd(x, y, gate, scale, g_newx, g_out)])
    plain_ms = cuda_ms([lambda: ga.gated_adaln_bwd_plain(x, y, gate, scale, g_newx, g_out)])
    # x, y, g_newx, g_out read once; dx, dy written once; gate/scale read and
    # dgate/dscale/dshift written once; ~20 fp32 flops per element
    nbytes = 6 * b * n * d * 2 + 5 * b * d * 2
    flops = 20.0 * b * n * d
    return kernel_row("gated_adaln_bwd", "gated_adaln", "f5e_tts_tpu/ops/pallas_norm.py:159",
                      launches, err, ms, plain_ms, flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES,
                      None)


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, ops_s, bytes_s,
               library_ms) -> dict:
    """One row of the kernels line. `launches` is {path: launches in one run
    of it}; the row's `launches` is the first path's."""
    bound_s = max(ops_s, bytes_s)
    row = {"name": name, "route": "cuda", "source": f"f5e_tts_tpu_torch/csrc/{source}.cu",
           "replaces": replaces, "launches": next(iter(launches.values())),
           "launches_by_path": launches, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
           "bound_by": "operations" if ops_s >= bytes_s else "bytes", "library_ms": library_ms}
    log(f"[{name}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms "
        f"({row['bound_by']}), library {library_ms if library_ms is None else round(library_ms, 4)} ms")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from f5e_tts_tpu_torch.kernels import _build
    from f5e_tts_tpu_torch.kernels import gated_adaln as ga
    from f5e_tts_tpu_torch.kernels import rope_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {len(libs)} kernels built in {time.perf_counter() - t0:.1f} s")
    for path in libs.values():
        build_log = path.with_name(path.name + ".log")
        for line in build_log.read_text().splitlines() if build_log.exists() else []:
            if "registers" in line or "spill" in line:
                log(f"[build] {path.name}: {line.strip()}")

    with torch.inference_mode():
        synth = synthesis_phase(ra, ga)
    step = training_phase(ra, ga)
    torch.cuda.empty_cache()
    gradient_phase(ra, ga)
    paths = {name: {"synthesis": synth[name], "training_step": step[name]} for name in synth}
    with torch.inference_mode():
        rows = [attention_phase(ra, paths["rope_attention"]),
                adaln_phase(ga, paths["gated_adaln"])]
    torch.cuda.empty_cache()
    rows += [attention_bwd_phase(ra, {"training_step": step["rope_attention_bwd"]}),
             adaln_bwd_phase(ga, {"training_step": step["gated_adaln_bwd"]})]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
