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
4. One phase per kernel at the main path's shapes: kernel vs its plain
   PyTorch version on the same inputs (bf16 tolerance below), kernel, plain
   and library times, and the least time the card could take.
5. Prints one JSON line with every kernel, then the device line last.

Exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository. fp32 matmuls and convolutions run with TF32 off
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
False), so the plain versions are full fp32 references.
"""

from __future__ import annotations

import json
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


def write_reference_wav(path: Path, seconds: float = 5.03, sr: int = 24_000, seed: int = 0) -> None:
    """A seeded speech-like signal: harmonics of a gliding pitch under a
    syllable-rate envelope, plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t)) ** 2
    wav = 0.1 * envelope * voiced + 0.005 * rng.standard_normal(t.size)
    pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
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
    profile_synthesis(infer, wall)
    return counts


# kernel-name fragments -> the layer they belong to, first match wins
KERNEL_GROUPS = (("rope_attention", "K1 rope_attention"), ("gated_adaln", "K2 gated_adaln"),
                 ("fprop", "convolution"), ("conv", "convolution"), ("fft", "fft"),
                 ("gemm", "matmul"), ("nvjet", "matmul"), ("cutlass", "matmul"),
                 ("xmma", "matmul"))


def profile_synthesis(infer, wall: float) -> None:
    """Device time of one more synthesis by kernel and by layer (torch.profiler),
    and the device's busy share of the unprofiled warm wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        infer()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log("[profile] torch.profiler saw no device time: busy share not measured")
        return
    groups: dict = {}
    for e in kernels:
        name = e.key.lower()
        group = next((g for frag, g in KERNEL_GROUPS if frag in name), "elementwise and other")
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e.self_device_time_total / 1e3, n + e.count)
    log(f"[profile] device busy {busy_ms:.1f} ms of the {wall * 1e3:.1f} ms warm wall: "
        f"busy share {busy_ms / (wall * 1e3):.3f}")
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[profile] {group}: {ms:.1f} ms ({ms / busy_ms:.3f} of busy), {n} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x {e.key[:90]}")


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
    return kernel_row("rope_attention", "f5e_tts_tpu/ops/pallas_attention.py:523", launches, err,
                      ms, plain_ms, flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES, library_ms)


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
    return kernel_row("gated_adaln", "f5e_tts_tpu/ops/pallas_norm.py:38", launches, err, ms,
                      plain_ms, flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES, None)


def kernel_row(name, replaces, launches, err, ms, plain_ms, ops_s, bytes_s, library_ms) -> dict:
    bound_s = max(ops_s, bytes_s)
    row = {"name": name, "route": "cuda", "source": f"f5e_tts_tpu_torch/csrc/{name}.cu",
           "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
           "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
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
        counts = synthesis_phase(ra, ga)
        rows = [attention_phase(ra, counts["rope_attention"]),
                adaln_phase(ga, counts["gated_adaln"])]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
