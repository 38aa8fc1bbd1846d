"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every hand-written kernel from f5e_tts_tpu_torch/csrc with nvcc,
   one process per source, all at once, and prints each kernel's registers,
   spills and shared memory (ptxas's report; the attention kernels' dynamic
   shared memory from the library). Every gated_adaln_kernel (K2)
   instantiation's SASS (cuobjdump -sass) must move its rows in 128-bit
   global loads and stores, and in no 16-bit ones.
3. Full-width zero-shot synthesis through the user entry point:
   F5TTS(model="F5TTS_v1_Base", device="cuda") in bf16 with seeded random
   weights, NFE 32, cfg 2, sway -1, a ~5 s seeded reference wav and
   fix_duration so the chunk lands in the 1536 bucket. Checks a finite wav
   with nonzero RMS, that the sampler output equals the cond mel on the
   prompt frames, and the launch counts of every run: depth x NFE of K1 and
   K2, 0 of every other kernel. A warm-up run, then three timed runs (wall
   time and RTF, the median and each), then one run under torch.profiler:
   device time by layer and by kernel, and the device's busy share of the
   timed run's wall time.
4. Full-width training through the user entry point: Trainer("F5TTS_v1_Base",
   device="cuda").train(loader, ...) with fp32 master weights, bf16 compute,
   dropout 0.1 and the byte tokenizer, on one batch of 8 seeded speech-like
   clips of 21.9-24.5 s packed by the port's build_loader under the
   19,200-frame budget (8 x N=2304); the mel runs on the card. Four updates (a
   warm-up step, then three timed ones), checked in train()'s log_fn: every step
   launches each of K1, K2, K4 and K5 exactly depth times and no other
   kernel, gives a finite loss and gradient norm and moves the params; the
   EMA follows ema_decay_at. A fixed-draw, dropout-free evaluation of
   cfm_loss is lower after the steps than before; model_last loads back
   equal and its EMA export re-ingests. The step wall, valid frames per
   second, peak memory, one profiled step, then a resumed train() that
   fast-forwards the loader and repeats that step's loss.
5. Gradient phase: a 2-block Base-width DiT's cfm_loss and every gradient at
   B=2, N=1024, fixed draws, dropout 0, once through the kernels and once
   with this script swapping the wrappers for their plain versions: loss
   within 1e-2 relative, each parameter's gradient at cosine >= 0.99.
6. MMDiT synthesis at full width (MMDiTConfig(): dim 1024, depth 8, 16 x 64)
   through TTSEngine.infer: the same reference and bucket, a text padded to
   128 tokens (N + Nt = 1664). 8 x NFE launches of K7, 0 of every other
   attention kernel; the checks and measurements of 3.
7. MMDiT training at full width through Trainer.train: four updates on the
   same 8 clips; 8 launches of K9 and of K10 a step and 0 of K7/K8; the
   checks and measurements of 4 without the resumed run, the EMA export in
   the reference MMDiT layout.
8. The partial-RoPE preset: one synthesis through F5TTS(model="F5TTS_Base")
   (depth x NFE launches of K3; the measurements of 3 from one timed run)
   and two Trainer updates (depth of K3 and of
   K6 a step), counted on counters of their own; this phase saves nothing.
9. Gradient phase of the MMDiT: 2 blocks at full width, B=2, N=1024, Nt=96,
   with a padding mask, through backbone.forward_train and a masked MSE
   against a seeded target, so K7 and K8 launch twice each; limits as in 5.
10. EPSS synthesis: the v1 synthesis of 3 through F5TTS.infer(timesteps=)
    with the 8-of-32 pruned grid of scripts/quality_proxy.py
    (pruned_sway_timesteps((0, 1, 2, 3, 4, 6, 10, 18, 32))): depth x 8
    launches of K1 and K2, the measurements of 3; the full keep set
    range(33) gives the bits of the default 32-step run.
11. Captured synthesis: the v1 sampler of bucket 1536 captured as a CUDA
    graph at NFE 32 and on the EPSS grid (utils/aot.py), with the capture's
    seconds, the memory it reserved and its launch counts (depth x (steps +
    1) of K1 and K2 an engine: the loop and one warm-up step). A replay from
    the eager run's noise gives the eager sampler output's bits and counts
    no launch; one replay under torch.profiler runs K1's pre-pass and main
    kernel and K2's kernel depth x NFE times each. The sampler's device time
    eager and replayed, then three timed warm syntheses through F5TTS.infer
    on each engine (wall, RTF, busy share, device kernels) whose wav is the
    eager run's.
12. Device-resident decode and streaming: the vocoder's `.device` decode of
    a slice_gen window gives the host decode's wav for the same mel, and a
    one-chunk request's streamed pieces concatenate to its wav.
    (10-12, 15 and 16 run on one more v1 model, after 13 and 14.)
13. E2 synthesis: F5TTS(model="E2TTS_Base") at full width and depth (a
    UNetT: dim 1024, depth 24, 16 x 64, ff x4, RoPE on the first head, concat
    skips; no AdaLN), the synthesis of 3: the time token makes attention run
    on N+1 = 1537 rows, so E2_DEPTH x NFE launches of K3 and none of K2. Its
    sampler captured for bucket 1536 (E2_DEPTH x (NFE + 1) K3 launches
    counted at capture): a replay gives the eager bits, the sampler's device
    time eager and replayed, three timed warm syntheses on the engine.
14. E2 training: two Trainer.train updates of it on the batch of 4 (N+1 =
    2305 rows): E2_DEPTH launches of K3 and K6 a step, none of K2/K5;
    frames/s and peak memory as in 4; nothing saved.
15. TTS sampler mode: synthesize_chunk(mode="tts") with alpha_spk =
    alpha_txt = 1 + cfg (one 3B batch a step, depth x NFE of K1 and K2)
    against plain-CFG sample(cfg) from the same noise: the prompt frames
    equal, the generated frames within TTS_REL in relative L2; the device
    time of the TTS sampler against the plain one's (from 11).
16. Speech editing: edit_speech over one span of the seeded reference,
    re-timed so the request lands in bucket 1536: every kept frame of the
    sampler output equals the cond mel bit for bit, the wav is finite.
17. PPG extraction: PPGExtractor(ConformerConfig()) (12 Conformer blocks,
    256 wide, 4 heads, conv2d subsampling) with seeded weights and CMVN, on
    the card in fp32: audio_to_ppg of the 8 training clips resampled to 16
    kHz against the same call on the CPU in fp32 (F5E_PPG_REL); device ms
    per second of audio. (17-21 run after 14, before 10.)
18. F5E training: the model of configs/example.yaml built in code
    (f5e_model_config: F5TTS_Small's DiT with PPG conditioning, the shared
    codebook and activation checkpointing under "block"; byte tokenizer)
    through Trainer(ppg_extractor=...).train on the 8 clips, the loader
    carrying 16 kHz audio: a warm-up update and three timed ones, each with
    2 x depth launches of K3 and K2 (the forward and its recompute) and
    depth of K6 and K5, a finite loss, a codebook loss > 0 unless the step
    drew the drop-everything cell, params and BatchNorm statistics that
    move; the fixed-draw eval loss falls, model_last (BatchNorm state
    included) loads back equal and its EMA export re-ingests with the
    running statistics, a resumed train() repeats the profiled step's loss.
    Then two updates without remat (depth of each kernel a step): wall and
    peak memory for the trade-off.
19. F5E gradients: a 2-block F5E DiT at full width with the align loss and
    the cross mask on, B=2, N=1024, fixed draws, dropout 0, remat "block":
    kernels vs plain versions (the limits of 5), then remat off gives the
    same loss and gradients bit for bit; MAS on the card equals the CPU's
    path; MAS timed at (B=8, T_y=2304, T_x=384).
20. F5E serving: a TTSEngine over the full-width F5E model and the PPG of the
    reference from 17: synthesize_chunk in the vc (alpha_spk 1.5, alpha_ppg
    2), tts and cfg modes (depth x NFE launches of K3 and K2 each, a 3B
    batch in vc and tts), then cfg on an engine captured for bucket 1536
    (depth x (NFE + 1) at capture; the replay gives the eager bits and
    counts no launch). Each: prompt frames equal the cond mel, a finite wav
    with nonzero RMS, the sampler's device busy and three timed walls.
21. (The F5E model's kernel shapes in 35: K3 at (2, 1536) with 12 heads, K6
    at (8, 2304) with 12 heads, K2 at (2, 1536, 768), K5 at (8, 2304, 768).)
22. PPG engines: capture_ppg_buckets of the F5E extractor over the fbank
    buckets (400, 800, 1600, 3200) as CUDA graphs: the capture's seconds
    and memory; replays of 4, 9 and 22 s clips padded into their buckets
    equal eager mel_to_ppg bit for bit; device time per second of audio.
23. Offline extraction: ppg_extract_cli.main over four written 16 kHz wavs
    with the extractor's weights as a wenet checkpoint and train.yaml: each
    .npy has true_len rows and equals audio_to_ppg of its file within 1e-5.
24. ASR training: the Conformer at full width with CE and CTC heads of 5000
    tokens over the 8 clips' fbank (185.6 s), seeded frame and CTC labels:
    three make_asr_train_step updates, each with a dynamic chunk mask; the
    first step's loss on the card equals the CPU's within ASR_REL; then
    asr_loss with the softmax speaker branch (the GRL flips the encoder's
    gradient against coeff -1) and attention_loss of DecoderConfig(
    r_num_blocks=3), backpropagated. Step wall, device busy, peak memory.
25. Streaming: conformer_encode_chunk_by_chunk of a 10 s clip, chunk 16,
    left chunks -1 and 4, card vs CPU; the RTF, and the device time per
    chunk at left chunks -1.
26. Recognition: recognize in the ctc_greedy_search and attention modes on
    the card and the CPU: equal token lists, or a top-two logit margin under
    TIE_MARGIN at the first difference.
27. Derived-span edit (on the serving v1 model, after 16): the trained CTC
    head's log-probs over the reference at 16 kHz give the span of "mother"
    by forced alignment (card == CPU), and edit_speech over it launches
    depth x NFE of K1 and K2 with every kept frame equal to the cond mel.
28. The training CLI: train.main over configs/example.yaml (byte tokenizer,
    bnb_optimizer, the codebook off: the CLI's batches carry no PPG lengths,
    which the codebook branch needs, in JAX as in the port) and an Arrow
    dataset of the 8 clips: two updates of 2 x
    depth K3 and K2 and depth K6 and K5 each, the 8-bit AdamW state under
    0.3x the fp32 state's bytes, a second main() resuming at update 3 (its
    step's device busy under torch.profiler). (22-26 run after 20; 28 after
    34.)
29. Sampler options (on the serving v1 model cut to 2 blocks at full
    width): cfm.sample(use_mask=False) and the duplicate_test probe
    (t_start 0.5 with a seeded test_cond: 4 of 8 steps from t = 0.5) on the
    card in bf16 against the CPU in fp32 from the same y0 (OPTIONS_REL),
    2 x steps of K1 and K2; use_mask=False changes the output's bits.
30. Per-request seeds: one seed's noise alone, in slot 2 of a batch of
    three and as synthesize_chunk's draw, the same bits on the card; the
    full-width sampler of the lone request gives synthesize_chunk(seed=)'s
    eager bits, the batch's slot 2 agrees with it within SEED_REL (a batch's
    device busy against one request's: 34).
31. Int8 W8A8: F5TTS("F5TTS_v1_Base", quantize="int8") with the serving
    model's weights, the synthesis of 3 with one timed run and no profile
    (depth x NFE of K1 and K2), the
    generated mel's relative L2 against the bf16 model's from the same
    noise, the eager sampler's device busy beside bf16's and the share the
    per-token quantization passes take (each quantized linear timed against
    its torch._int_mm and the bf16 linear); its bucket-1536 engine captured,
    the replay gives the eager bits, replay busy beside bf16's, three timed
    captured syntheses.
32. Engine directories: F5TTS(engine_dir=, asr_model=) over empty files
    named as the JAX exporter names engines: the captured engines are
    exactly those named, replays give the eager bits.
33. Whisper transcription (the same model, a stand-in pipeline): an empty
    ref_text is transcribed once on the card and cached, and the synthesis
    equals the one with the transcript given.
34. Batched serving (a TTSEngine over the same weights, bucket 1536, NFE 32,
    cfg 2): TTSEngine.enable_batching(max_batch=4); four requests (distinct
    seeds, reference lengths 4.0-5.5 s and texts, SERVE_REQUESTS) alone on
    the direct path, then from four threads at once through infer: one batch
    of 4 (depth x NFE of K1 and K2), each request's mel within SERVE_REL of
    its mel alone (bitwise printed). warm_up_buckets(buckets=(1536,))
    captures the (1, 1536), (2, 1536) and (4, 1536) engines (3 x depth x
    (NFE + 1) counted at capture; seconds, memory) and runs each batch size
    through the batcher; the four again, alone (the eager bits) and as one
    replayed batch (no launch; the eager batch's bits). The int16 wire
    within 1/32767 + 1 ulp of the float32 wav, xfer_chunks=2 and
    return_mel=False its wavs. The HTTP (one request, then four at once: one
    batch of 4), socket (f32, pcm16) and gRPC (streaming, offline) servers on
    free ports of 127.0.0.1, each answering with a finite non-silent wav.
    Load numbers, printed with no gate: bench_concurrent at concurrency 4
    against four sequential requests, eager and captured, one profiled batch
    of 4 each (busy share), one bench_openloop run; the sampler's device busy
    for a batch of 4 against one request, eager and replayed. (29-34 run
    after 27.)
35. One phase per kernel at the shapes of its path and at one ragged case:
    kernel vs its plain PyTorch version on the same inputs (tolerances
    below), kernel, plain and library times, the least time the card could
    take, and the host time per call of each forward wrapper and of K5's.
    The K1, K4 and K5 rows' `also` split one call's device time at the
    training shape into its kernels: pre-pass and main kernel; pre-pass,
    dq and dkdv; row pass and combine (torch.profiler, measured after the
    build, before the model phases). The backward kernels, K5 included,
    must give the same bits in two runs. K1 and K2 are also held at the
    batcher's batch of 4: K1 at (8, 1536, 16, 64) with four key lengths, K2
    at (8, 1536, 1024).
36. Prints one JSON line with every kernel, then the device line last.

Exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository. fp32 matmuls and convolutions run with TF32 off
(torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
False), so the plain versions are full fp32 references.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
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
DEPTH, MMDIT_DEPTH, E2_DEPTH, NFE = 22, 8, 24, 32
# kernel vs plain on unit-scale bf16 inputs: both round the same fp32 values
# to bf16, so they differ by accumulation order and at most ~1 bf16 ulp
ATOL, RTOL = 2e-2, 1e-2
# the backward kernels' gradients are small sums of many rounded terms, and
# they form delta from the bf16 output where the plain versions sum P * dP
# in fp32: max |kernel - plain| <= BWD_REL * max |plain| for each of dq, dk, dv
BWD_REL = 2e-2
TRAIN_CLIPS, TRAIN_N = 8, 2304
REF_TEXT = "Some call me nature, others call me mother nature."
GEN_TEXT = "I love the way the light falls across the water early in the morning."
FIX_DURATION = 15.11  # int(15.11 * 24000 / 256) = 1416 frames -> bucket 1536
PALLAS = "f5e_tts_tpu/ops/pallas_attention.py"


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# launch counts: one counter per TPU kernel's counterpart
# ---------------------------------------------------------------------------

COUNTERS: dict = {}  # name -> (module, attribute); filled by main()


def register_counters(ra, ga, ka) -> None:
    COUNTERS.update({
        "rope_attention": (ra, "launches"), "rope_attention_bwd": (ra, "bwd_launches"),
        "partial_rope_attention": (ra, "partial_launches"),
        "partial_rope_attention_bwd": (ra, "partial_bwd_launches"),
        "gated_adaln": (ga, "launches"), "gated_adaln_bwd": (ga, "bwd_launches"),
        "masked_attention": (ka, "masked_launches"),
        "masked_attention_bwd": (ka, "masked_bwd_launches"),
        "joint_attention": (ka, "joint_launches"),
        "joint_attention_bwd": (ka, "joint_bwd_launches")})


def reset_counts() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counts() -> dict:
    """Every counter's value, then all set to 0."""
    counts = {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}
    reset_counts()
    return counts


def expected_counts(**nonzero) -> dict:
    return {name: nonzero.get(name, 0) for name in COUNTERS}


def check_counts(tag: str, counts: dict, expected: dict) -> None:
    if counts != expected:
        want = {k: v for k, v in expected.items() if v}
        got = {k: v for k, v in counts.items() if v or expected[k]}
        raise AssertionError(f"{tag}: launches {got}, expected {want} and 0 of every other kernel")


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


def host_us(fn, calls: int = 25, batches: int = 20) -> float:
    """Host time in us of one call of `fn` (Python, checks, allocation,
    launch): the least mean over `batches` batches of `calls` calls, each
    enqueued behind a device sleep so a full queue never holds the host
    (the least, since the host's cores are shared and a batch only ever
    runs slower than the code's own cost)."""
    fn()
    best = math.inf
    for _ in range(batches):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)  # ~0.05 s at the H100's 1.98 GHz boost clock
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / calls * 1e6


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


def seed_modulation_(params, gen) -> None:
    """AdaLN-zero leaves every block an identity at init and the output
    projection zero, so no gradient would reach the trunk on the first step
    and no kernel would shape a wav; small seeded modulation (`attn_norm*`,
    `norm_out`) and output (`proj_out`) weights make every kernel carry one.
    The UNetT's norms are RMSNorm gains, not linears, and stay as they are."""
    def walk(node):
        if isinstance(node, list):
            for sub in node:
                walk(sub)
        elif isinstance(node, dict):
            for key, sub in node.items():
                if (key.startswith("attn_norm") or key in ("norm_out", "proj_out")) and "w" in sub:
                    sub["w"].copy_(0.02 * torch.randn(sub["w"].shape, generator=gen,
                                                      device=sub["w"].device))
                else:
                    walk(sub)

    with torch.no_grad():
        walk(params)


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------


def synthesis_phase(tag: str, infer, expected: dict, runs: int, text_len=None,
                    timesteps=None, profile: bool = True) -> dict:
    """`runs` timed runs of `infer()` -> (wav, sr, mel) after a warm-up, each
    with the launch counts checked, then a profiled one unless not
    `profile`; returns the counts of the last timed run. The sampler must
    have run NFE steps, or over `timesteps` when given."""
    from f5e_tts_tpu_torch.models import cfm as fcfm

    captured = []
    sample = fcfm.sample

    def recording_sample(params, arch, cfm, inputs, **kw):
        out = sample(params, arch, cfm, inputs, **kw)
        captured.append((out[0], inputs, kw))
        return out

    fcfm.sample = recording_sample
    walls = []
    try:
        for run in ["warm-up"] + [f"timed {i + 1}" for i in range(runs)]:
            captured.clear()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav, sr, mel = infer()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            log(f"[{tag}] {run}: wall {wall:.3f} s, launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            check_counts(f"{tag} {run}", counts, expected)
            if run != "warm-up":
                walls.append(wall)
    finally:
        fcfm.sample = sample

    if len(captured) != 1:
        raise AssertionError(f"expected one chunk, the sampler ran {len(captured)} times")
    out, inputs, kw = captured[0]
    if (tuple(out.shape) != (1, 1536, 100) or kw["steps"] != NFE or kw["cfg_strength"] != 2.0
            or kw.get("timesteps") != timesteps):
        raise AssertionError(f"unexpected sampler call: shape {tuple(out.shape)}, {kw}")
    if text_len is not None and inputs.text_ids.shape[1] != text_len:
        raise AssertionError(f"text padded to {inputs.text_ids.shape[1]}, expected {text_len}")
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
    log(f"[{tag}] prompt frames {ref_frames} preserved exactly; duration {duration} "
        f"frames in bucket 1536, text padded to {inputs.text_ids.shape[1]}; wav {len(wav)} "
        f"samples ({audio_s:.3f} s), rms {rms:.4f}")
    wall = float(np.median(walls))
    log(f"[{tag}] one warm synthesis (median of {len(walls)}): wall {wall:.3f} s, "
        f"RTF {wall / audio_s:.5f} (wall / seconds of generated audio); "
        f"RTF of each: {[round(w / audio_s, 5) for w in walls]}")
    if profile:
        profile_run(f"{tag} profile", infer, wall)
    reset_counts()
    return counts


def reference_wav() -> Path:
    ref = ROOT / "build" / "smoke" / "ref.wav"
    write_reference_wav(ref)
    return ref


def preset_tts(tag: str, model: str, depth: int = DEPTH, **kw):
    """Full-width F5TTS(model, **kw) on the card with seeded weights (the
    same weights for one model whatever `kw` asks: `quantize` codes them
    before the modulation is seeded, which it leaves as it is)."""
    from f5e_tts_tpu_torch.api import F5TTS

    t0 = time.perf_counter()
    tts = F5TTS(model=model, device="cuda", compute_dtype=torch.bfloat16, seed=0, **kw)
    arch = tts.engine.arch
    assert (arch.dim, arch.depth, arch.heads, arch.dim_head) == (1024, depth, 16, 64), arch
    seed_modulation_(tts.engine.params, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    log(f"[{tag}] {model} built in {time.perf_counter() - t0:.1f} s")
    return tts


def preset_synthesis_phase(tag: str, tts, expected: dict, runs: int) -> dict:
    """Full-width `tts.infer` of the reference and text, bucket 1536."""
    ref = str(reference_wav())

    def infer():
        return tts.infer(ref, REF_TEXT, GEN_TEXT, nfe_step=NFE, cfg_strength=2.0,
                         sway_sampling_coef=-1.0, fix_duration=FIX_DURATION, seed=7)

    return synthesis_phase(tag, infer, expected, runs)


def mmdit_synthesis_phase(expected: dict) -> dict:
    """Full-width MMDiT through TTSEngine.infer (no preset names an MMDiT, so
    the engine is built here as F5TTS builds its own)."""
    from f5e_tts_tpu_torch.api import _cast, load_vocoder
    from f5e_tts_tpu_torch.config import MMDiTConfig
    from f5e_tts_tpu_torch.infer import audio as faudio
    from f5e_tts_tpu_torch.infer.pipeline import TTSEngine, preprocess_ref_audio_text
    from f5e_tts_tpu_torch.models.mmdit import init_mmdit

    t0 = time.perf_counter()
    arch = MMDiTConfig()
    assert (arch.dim, arch.depth, arch.heads, arch.dim_head) == (1024, MMDIT_DEPTH, 16, 64), arch
    params = init_mmdit(arch, 256, torch.Generator(device="cuda").manual_seed(0), "cuda")
    seed_modulation_(params, torch.Generator(device="cuda").manual_seed(1))
    engine = TTSEngine(params=_cast(params, torch.bfloat16), arch=arch, vocab=None,
                       vocoder_decode=load_vocoder(None, torch.bfloat16, "cuda", 0),
                       compute_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[mmdit synthesis] MMDiT built in {time.perf_counter() - t0:.1f} s")
    wav, sr = faudio.read_wav(str(reference_wav()))
    wav, ref_text = preprocess_ref_audio_text(wav, sr, REF_TEXT)

    def infer():
        return engine.infer(wav, sr, ref_text, GEN_TEXT, seed=7, fix_duration=FIX_DURATION,
                            nfe_steps=NFE, cfg_strength=2.0, sway=-1.0)

    return synthesis_phase("mmdit synthesis", infer, expected, runs=3, text_len=128)


# kernel-name fragments (all must occur) -> the layer they belong to, first
# match wins; the attention kernels carry their variant's name
KERNEL_GROUPS = ((("attention_bwd", "ropeattn"), "K4/K6 rope attention bwd"),
                 (("attention_fwd", "ropeattn"), "K1/K3 rope attention"),
                 (("attention_bwd", "maskedattn"), "K10 masked attention bwd"),
                 (("attention_fwd", "maskedattn"), "K9 masked attention"),
                 (("attention_bwd", "jointattn"), "K8 joint attention bwd"),
                 (("attention_fwd", "jointattn"), "K7 joint attention"),
                 (("gated_adaln_bwd",), "K5 gated_adaln_bwd"), (("gated_adaln",), "K2 gated_adaln"),
                 (("multi_tensor_apply",), "optimizer (foreach)"),
                 (("fprop",), "convolution"), (("dgrad",), "convolution"),
                 (("wgrad",), "convolution"), (("conv",), "convolution"), (("fft",), "fft"),
                 (("gemm",), "matmul"), (("nvjet",), "matmul"), (("cutlass",), "matmul"),
                 (("xmma",), "matmul"), (("ctc_loss",), "CTC loss"))


def device_kernels(prof) -> list:
    """The device kernels of a torch.profiler run, one event a launch, the
    device sleep left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and "sleep" not in e.name.lower()]


def kernel_ms(kernels) -> float:
    """The summed durations of `kernels`, in ms."""
    return sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3


def busy_ms(kernels) -> float:
    """The ms in which at least one of `kernels` ran: the union of their
    intervals. Kernels that run at once on several streams (cuDNN launches a
    grouped convolution's groups on streams of its own, and a graph replays
    them concurrently) count once, where `kernel_ms` counts each."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def profile_run(tag: str, fn, wall: float) -> None:
    """Device time of one more run of `fn` by kernel and by layer
    (torch.profiler), and the device's busy share of the unprofiled warm
    wall time `wall`. Busy is the union of the kernels' intervals; a
    layer's kernel time sums its kernels, and its busy time is the union of
    its own, on the streams named."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = busy_ms(kernels)
    if busy <= 0:
        log(f"[{tag}] torch.profiler saw no device time: busy share not measured")
        return
    groups: dict = {}
    for e in kernels:
        name = e.name.lower()
        group = next((g for frags, g in KERNEL_GROUPS if all(f in name for f in frags)),
                     "elementwise and other")
        groups.setdefault(group, []).append(e)
    log(f"[{tag}] device busy {busy:.1f} ms of the {wall * 1e3:.1f} ms warm wall: "
        f"busy share {busy / (wall * 1e3):.3f}; kernel time {kernel_ms(kernels):.1f} ms in "
        f"{len(kernels)} device kernels")
    for group, ev in sorted(groups.items(), key=lambda kv: -kernel_ms(kv[1])):
        ms = kernel_ms(ev)
        streams = sorted({e.device_resource_id for e in ev})
        log(f"[{tag}] {group}: {ms:.1f} ms kernel time ({ms / busy:.3f} of busy), busy "
            f"{busy_ms(ev):.1f} ms on {len(streams)} stream(s), {len(ev)} launches")
    by_name: dict = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e)
    for name, ev in sorted(by_name.items(), key=lambda kv: -kernel_ms(kv[1]))[:10]:
        log(f"[{tag}]   {kernel_ms(ev):8.2f} ms {len(ev):6d}x {name[:100]}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

SENTENCES = (REF_TEXT, GEN_TEXT,
             "The quick brown fox jumps over the lazy dog near the quiet river bank.",
             "She sells sea shells by the sea shore, and the shells she sells are surely seashells.")


def training_rows() -> list:
    """TRAIN_CLIPS seeded speech-like clips of 21.9-24.5 s at 24 kHz with
    their transcripts."""
    seconds = np.linspace(21.9, 24.5, TRAIN_CLIPS)
    return [{"audio": {"array": speech_like(sec, seed=i + 1).astype(np.float32),
                       "sampling_rate": 24_000},
             "text": " ".join(SENTENCES[(i + j) % len(SENTENCES)] for j in range(5)),
             "duration": float(sec)} for i, sec in enumerate(seconds)]


def training_loader(trainer, tc, with_16k_audio: bool = False):
    """A loader over the training rows with byte-tokenized transcripts,
    packed by the port's build_loader under the trainer's frame budget into
    one batch; `with_16k_audio` adds the clips at 16 kHz (PPG training)."""
    from f5e_tts_tpu_torch.data import dataset as fdata

    rows = training_rows()
    ds = fdata.ArrowSpeechDataset(rows, durations=[r["duration"] for r in rows],
                                  mel=trainer.model_cfg.mel, with_16k_audio=with_16k_audio)
    loader = fdata.build_loader(ds, trainer.tokenize, frames_threshold=tc.batch_size_per_device,
                                max_samples=tc.max_samples, seed=tc.seed)
    batches = list(loader)
    if len(batches) != 1 or batches[0]["audio"].shape != (TRAIN_CLIPS, TRAIN_N * 256):
        raise AssertionError(f"expected one batch of {TRAIN_CLIPS} x {TRAIN_N} frames, got "
                             f"{[b['audio'].shape for b in batches]}")
    return loader


def fixed_draws(gen, b: int, n: int, mel_dim: int, k: int, ppg: bool = False):
    """k sets of cfm_loss draws with no condition drop, from `gen`: u1 = 1
    keeps the audio, and u2 = 1 (no drop without PPG) or, for a PPG model,
    u2 = 0 (the drop table's "keep both" cell)."""
    from f5e_tts_tpu_torch.models.cfm import LossDraws

    one = torch.ones((), device="cuda")
    return [LossDraws(frac=0.7 + 0.3 * torch.rand(b, generator=gen, device="cuda"),
                      span=torch.rand(b, generator=gen, device="cuda"),
                      x0=torch.randn((b, n, mel_dim), generator=gen, device="cuda"),
                      time=torch.rand(b, generator=gen, device="cuda"), u1=one,
                      u2=0 * one if ppg else one)
            for _ in range(k)]


def drawn_cell(seed: int, b: int, n: int, mel_dim: int, table) -> str:
    """The drop-table cell a training step with generator seed `seed` draws:
    cfm_loss draws frac, span, x0, time, u1 and u2 in this order."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for shape in ((b,), (b,)):
        torch.rand(shape, generator=gen, device="cuda")
    torch.randn((b, n, mel_dim), generator=gen, device="cuda")
    torch.rand((b,), generator=gen, device="cuda")
    torch.rand((), generator=gen, device="cuda")
    u2 = float(torch.rand((), generator=gen, device="cuda"))
    edges = np.cumsum(table)[:3]
    return ("keep both", "drop text", "drop ppg", "drop all")[int(np.searchsorted(edges, u2,
                                                                                   "right"))]


def training_phase(tag: str, model_cfg, expected: dict, updates: int, warmup: int,
                   checkpoints: bool = True, resume: bool = False, extractor=None) -> dict:
    """`updates` full-width Trainer.train steps of `model_cfg` (the first is
    the warm-up); returns (the launch counts of the last step, the batch's
    text length). Without `checkpoints` the trainer's save is switched off
    here and nothing is written; `resume` adds a resumed train() that
    repeats the profiled step. With a PPG `extractor` (a PPG model) the
    loader carries 16 kHz audio and the trainer extracts the PPG on the
    card; each step's codebook loss and BatchNorm state are checked too."""
    from f5e_tts_tpu_torch.config import TrainConfig
    from f5e_tts_tpu_torch.models.backbone import split_state
    from f5e_tts_tpu_torch.train import step as fstep
    from f5e_tts_tpu_torch.train.trainer import Trainer, loss_with_device_mel
    from f5e_tts_tpu_torch.utils.convert import backbone_from_reference_state_dict, load_state_dict
    from f5e_tts_tpu_torch.utils.text import list_str_to_bytes

    t0 = time.perf_counter()
    arch = model_cfg.arch
    save_dir = ROOT / "build" / "smoke" / "ckpts"
    shutil.rmtree(save_dir, ignore_errors=True)
    # the JAX defaults, with the LR warm-up cut to `warmup` updates so the few
    # steps move the weights; only train()'s final model_last is saved
    tc = TrainConfig(num_warmup_updates=warmup, save_dir=str(save_dir), seed=0)

    def make_trainer(log_fn=None):
        trainer = Trainer(model_cfg, tc, vocab_size=256, tokenize=list_str_to_bytes, log_fn=log_fn,
                          device="cuda", ppg_extractor=extractor)
        if not checkpoints:
            trainer.save_checkpoint = lambda ts, last=False: None
        return trainer

    trainer = make_trainer()
    # the state train() consumes; steps update its tensors in place
    ts = trainer.init_state(total_updates=updates, rng_seed=0)
    seed_modulation_(ts.params, torch.Generator(device="cuda").manual_seed(1))
    ts.ema_params = fstep.tree_map(lambda t: t.detach().clone(), ts.params)
    n_params = sum(t.numel() for t in fstep.tree_leaves(ts.params))
    ppg = extractor is not None
    loader = training_loader(trainer, tc, with_16k_audio=ppg)
    batch = trainer.device_batch(next(iter(loader)))
    frames = int(batch["mel_lens"].sum())
    text_len = int(batch["text_ids"].shape[1])
    torch.cuda.synchronize()
    log(f"[{tag}] {model_cfg.name}: {n_params / 1e6:.1f}M fp32 params, batch audio "
        f"{tuple(batch['audio'].shape)} -> {TRAIN_CLIPS} x {TRAIN_N} frames, {frames} valid, "
        f"text {tuple(batch['text_ids'].shape)}" +
        (f", PPG {tuple(batch['ppg'].shape)} from 16 kHz audio "
         f"{tuple(batch['audio_16k'].shape)}" if ppg else "") +
        f"; set up in {time.perf_counter() - t0:.1f} s; "
        f"{shutil.disk_usage(ROOT).free / 2**30:.0f} GiB free on disk")

    draws = fixed_draws(torch.Generator(device="cuda").manual_seed(5), TRAIN_CLIPS, TRAIN_N,
                        arch.mel_dim, 4, ppg=ppg)

    def evaluate() -> float:
        with torch.no_grad():
            return float(np.mean([float(loss_with_device_mel(
                ts.params, arch, model_cfg.cfm, model_cfg.mel, batch, draws=d,
                compute_dtype=torch.bfloat16, training=False, state=ts.model_state).loss)
                for d in draws]))

    eval_before = evaluate()
    leaves, ema = fstep.tree_leaves(ts.params), fstep.tree_leaves(ts.ema_params)
    layers = ts.params.get("blocks") or ts.params["first_half"] + ts.params["second_half"]
    mid = layers[len(layers) // 2]
    # time_embed, a mid block's feed-forward (audio stream), proj_out
    probe = [leaves[0], mid.get("ff1", mid.get("ff1_x"))["w"], ts.params["proj_out"]["w"]]
    ema_settings = fstep.EMASettings.from_train_cfg(tc)
    seen = {"walls": [], "counts": {}, "before": [p.detach().clone() for p in probe]}

    def check_step(metrics: dict, update: int) -> None:
        """train()'s log_fn: the counts of this step alone, then reset."""
        counts = seen["counts"] = read_counts()
        wall = metrics["step_seconds"]  # the step ends in a host read of its loss
        log(f"[{tag}] step {len(seen['walls']) + 1}: update {update}, wall {wall:.3f} s, "
            f"loss {metrics['loss']:.5f}, grad norm {metrics['grad_norm']:.4f}, "
            f"launches { {k: v for k, v in counts.items() if v} }")
        if update != len(seen["walls"]) + 1:
            raise AssertionError(f"update {update} after {len(seen['walls']) + 1} steps")
        check_counts(f"{tag} step {update}", counts, expected)
        if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])):
            raise AssertionError(f"non-finite step: {metrics}")
        if any(torch.equal(b, p) for b, p in zip(seen["before"], probe)):
            raise AssertionError("a probed parameter did not change")
        seen["before"] = [p.detach().clone() for p in probe]
        if ppg:
            # the step's drop cell, from its generator; the perplexity loss
            # acts on each kept modality, so it is 0 only when all is dropped
            cell = drawn_cell(tc.seed * 1_000_003 + update - 1, TRAIN_CLIPS, TRAIN_N,
                              arch.mel_dim, arch.ppg.combined_cond_drop_prob)
            bn = ts.model_state["ppg_bn"]
            log(f"[{tag}] step {update}: drop cell {cell!r}, flow loss "
                f"{metrics['flow_loss']:.5f}, codebook loss {metrics['extra_loss']:.5f}; "
                f"BatchNorm count {int(bn[0]['count'])}, running mean[0] "
                f"{float(bn[0]['mean'][0]):.5f}")
            if (metrics["extra_loss"] > 0) != (cell != "drop all"):
                raise AssertionError(f"codebook loss {metrics['extra_loss']} in cell {cell!r}")
            if int(bn[0]["count"]) != update or torch.equal(bn[0]["mean"], seen.get(
                    "bn_mean", torch.zeros_like(bn[0]["mean"]))):
                raise AssertionError("the BatchNorm running statistics did not move")
            seen["bn_mean"] = bn[0]["mean"].clone()
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
    reset_counts()
    t1 = time.perf_counter()
    ts, info = trainer.train(loader, epochs=updates, resume=False, max_updates=updates)
    train_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    if (ts.update, info["updates"], len(seen["walls"])) != (updates,) * 3:
        raise AssertionError(f"train() ran {info} over {len(seen['walls'])} logged steps")
    counts = seen["counts"]
    kept = sorted(p.name for p in save_dir.iterdir())
    if kept != (["model_last.meta.json", "model_last.pt"] if checkpoints else []):
        raise AssertionError(f"unexpected checkpoints: {kept}")
    eval_after = evaluate()
    log(f"[{tag}] fixed-draw eval loss (4 draw sets, no dropout): before {eval_before:.6f}, "
        f"after {eval_after:.6f}")
    if not eval_after < eval_before:
        raise AssertionError("the fixed-draw eval loss did not fall over the steps")
    walls = seen["walls"][1:]  # the first step is the warm-up
    wall = float(np.median(walls))
    log(f"[{tag}] train(): {updates} updates in {train_s:.1f} s with checkpoints {kept}; "
        f"one warm step (median of {len(walls)}): wall {wall:.3f} s, "
        f"{frames / wall:.0f} valid frames/s; each: {[round(w, 4) for w in walls]}; "
        f"peak memory {peak / 2**30:.2f} GiB")

    if checkpoints:
        # the checkpoint train() saved last loads back equal, and its reference-
        # layout EMA export re-ingests as the EMA
        t1 = time.perf_counter()
        path = save_dir / "model_last.pt"
        restored = make_trainer().load_checkpoint(ts)
        pairs = [(fstep.tree_leaves(getattr(restored, k)), fstep.tree_leaves(getattr(ts, k)))
                 for k in ("params", "ema_params")]
        pairs.append((restored.opt_state.mu + restored.opt_state.nu,
                      ts.opt_state.mu + ts.opt_state.nu))
        pairs.append((fstep.tree_leaves(restored.model_state), fstep.tree_leaves(ts.model_state)))
        if not all(torch.equal(a, b) for got, want in pairs for a, b in zip(got, want)):
            raise AssertionError("the checkpoint did not round-trip")
        if (restored.update, restored.micro, restored.opt_state.count) != (
                ts.update, ts.micro, ts.opt_state.count):
            raise AssertionError("the checkpoint's counters did not round-trip")
        del restored, pairs
        ema_export, ema_state = split_state(arch, backbone_from_reference_state_dict(
            load_state_dict(str(path)), arch))
        running = [(a, b) for got, want in zip(ema_state.get("ppg_bn", []),
                                               ts.model_state.get("ppg_bn", []))
                   for a, b in ((got["mean"], want["mean"]), (got["var"], want["var"]))]
        if not all(torch.equal(a.cpu(), b.detach().cpu()) for a, b in zip(
                fstep.tree_leaves(ema_export), fstep.tree_leaves(ts.ema_params))) or not all(
                torch.equal(a.cpu(), b.cpu()) for a, b in running):
            raise AssertionError("the reference-layout EMA export does not load back")
        del ema_export
        log(f"[{tag}] checkpoint {path.name} ({path.stat().st_size / 2**30:.2f} GiB) loaded "
            f"back equal (params, EMA, moments, model state, counters, EMA export"
            f"{' with the BatchNorm statistics' if ppg else ''}) in "
            f"{time.perf_counter() - t1:.1f} s")

    # one more step, profiled: the next update from the same state
    profiled = {}
    step = trainer.make_step()
    profile_run(f"{tag} profile", lambda: profiled.setdefault(
        "loss", step(ts, batch, trainer.step_generator(ts))[1].loss), wall)

    if resume:
        # resume from model_last: train() fast-forwards the consumed batch and
        # repeats the profiled step's draws on the same state, so the same loss
        resumed = {}
        t1 = time.perf_counter()
        reset_counts()
        ts2, info2 = make_trainer(lambda m, u: resumed.update(m, update=u)).train(
            loader, epochs=updates + 1, resume=True, max_updates=updates + 1)
        counts2 = read_counts()
        log(f"[{tag}] resumed train(): {info2['updates']} update to {ts2.update} in "
            f"{time.perf_counter() - t1:.1f} s, loss {resumed['loss']:.6f} (the profiled step: "
            f"{profiled['loss']:.6f})")
        if (info2["updates"], ts2.update, resumed["update"]) != (1, updates + 1, updates + 1):
            raise AssertionError(f"the resumed run did not take exactly the next update: {info2}")
        check_counts(f"{tag} resumed step", counts2, expected)
        if not abs(resumed["loss"] - profiled["loss"]) <= 1e-5 * abs(profiled["loss"]):
            raise AssertionError("the resumed step's loss differs from the same step run directly")
        del ts2
    shutil.rmtree(save_dir, ignore_errors=True)
    reset_counts()
    return counts, text_len


# ---------------------------------------------------------------------------
# the F5E model (configs/example.yaml): PPG extraction, training, gradients, serving
# ---------------------------------------------------------------------------


def f5e_model_config():
    """The model of configs/example.yaml, built in code: F5TTS_Small's DiT
    (dim 768, depth 18, 12 x 64, ff x2, text dim 512, 4 ConvNeXt blocks,
    RoPE on the first head, no text padding mask) with activation
    checkpointing (policy "block"), PPG conditioning (dim 256, the drop
    table (0.3, 0.1, 0.5, 0.1)) and the shared codebook (100 codes x 2
    groups, the perplexity loss on a 0.1 share at weight 0.1). The byte
    tokenizer stands in for pinyin (pypinyin is absent);
    tests/test_torch_ppg.py holds it against config.load_yaml."""
    from f5e_tts_tpu_torch.config import CodebookConfig, DiTConfig, ModelConfig, PPGConfig

    arch = DiTConfig(dim=768, depth=18, heads=12, ff_mult=2, text_dim=512,
                     text_mask_padding=False, conv_layers=4, pe_attn_head=1,
                     checkpoint_activations=True,
                     ppg=PPGConfig(use_ppg=True, ppg_dim=256, frame_length=20, mel_frame_shift=10,
                                   output_type="ppg",
                                   combined_cond_drop_prob=(0.3, 0.1, 0.5, 0.1)),
                     codebook=CodebookConfig(use_codebook=True, num_vars=100, temp_start=2.0,
                                             temp_stop=0.5, temp_decay=0.999995, groups=2,
                                             use_perplex_loss=True, perplex_loss_prob=0.1,
                                             perplex_loss_weight=0.1))
    return ModelConfig(name="F5TTS_Small", tokenizer="byte", vocab_size=256, arch=arch)


F5E_DEPTH = 18
# the PPG of the card's fp32 extractor against the CPU's on the same inputs:
# max|card - cpu| <= F5E_PPG_REL * max|cpu| (fp32 GEMMs summed in another
# order through 12 layers; TF32 is off)
F5E_PPG_REL = 1e-3


def f5e_extractor_phase():
    """PPGExtractor(ConformerConfig()) with seeded weights and CMVN on the
    card in fp32: audio_to_ppg of the 8 training clips resampled to 16 kHz
    against the same call on the CPU; device ms per second of audio.
    Returns the card's extractor."""
    from f5e_tts_tpu_torch.infer.audio import resample
    from f5e_tts_tpu_torch.models.conformer import ConformerConfig, PPGExtractor, init_conformer
    from f5e_tts_tpu_torch.train import step as fstep

    cfg = ConformerConfig()
    assert (cfg.num_blocks, cfg.output_size, cfg.attention_heads, cfg.subsampling) == (
        12, 256, 4, "conv2d"), cfg
    gen = torch.Generator(device="cuda").manual_seed(21)
    params = init_conformer(cfg, gen, "cuda")
    # a CMVN of the int16-scale log-mel's range
    params["cmvn_mean"] = 8.0 + torch.randn(cfg.input_dim, generator=gen, device="cuda")
    params["cmvn_istd"] = 0.25 + 0.1 * torch.rand(cfg.input_dim, generator=gen, device="cuda")
    card = PPGExtractor(params=params, cfg=cfg, device="cuda")
    host = PPGExtractor(params=fstep.tree_map(lambda t: t.cpu(), params), cfg=cfg, device="cpu")
    clips = [resample(r["audio"]["array"], 24_000, 16_000) for r in training_rows()]
    lens = np.asarray([len(c) for c in clips], np.int64)
    wav = np.zeros((len(clips), int(lens.max())), np.float32)
    for i, c in enumerate(clips):
        wav[i, : len(c)] = c
    wav_t, lens_t = torch.from_numpy(wav).cuda(), torch.from_numpy(lens).cuda()
    ppg, ppg_lens = card.audio_to_ppg(wav_t, lens_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_lens = host.audio_to_ppg(wav, lens)
    host_s = time.perf_counter() - t0
    err, top = (ppg.cpu() - ref).abs().max().item(), ref.abs().max().item()
    log(f"[ppg extraction] {len(clips)} clips, {lens.sum() / 16_000:.2f} s of 16 kHz audio -> "
        f"PPG {tuple(ppg.shape)}, lengths {ppg_lens.tolist()}; card (fp32) vs CPU (fp32): "
        f"max|diff| {err:.3e}, max|cpu| {top:.3e} (tolerance {F5E_PPG_REL} * max|cpu|); the "
        f"CPU call took {host_s:.2f} s")
    if not (torch.isfinite(ppg).all() and torch.equal(ppg_lens.cpu(), ref_lens)
            and err <= F5E_PPG_REL * top and top > 0):
        raise AssertionError("the card's PPG disagrees with the CPU's")
    ms = cuda_ms([lambda: card.audio_to_ppg(wav_t, lens_t)], iters=5, warmup=1)
    log(f"[ppg extraction] device {ms:.3f} ms a batch, {ms / (lens.sum() / 16_000):.4f} ms per "
        f"second of audio")
    return card


def f5e_no_remat_phase(cfg, extractor) -> dict:
    """Two F5E updates without activation checkpointing (nothing saved): the
    step wall and peak memory against the checkpointed step of the training
    phase; depth launches of K3, K2, K6 and K5 a step."""
    arch = dataclasses.replace(cfg.arch, checkpoint_activations=False)
    counts, _ = training_phase(
        "f5e training, no remat", dataclasses.replace(cfg, arch=arch),
        expected_counts(partial_rope_attention=F5E_DEPTH, partial_rope_attention_bwd=F5E_DEPTH,
                        gated_adaln=F5E_DEPTH, gated_adaln_bwd=F5E_DEPTH),
        updates=2, warmup=1, checkpoints=False, extractor=extractor)
    return counts


def f5e_gradient_phase(swaps: dict) -> None:
    """cfm_loss and every gradient of a 2-block F5E DiT at full width (dim
    768, 12 heads) with the align loss and the cross mask on, B=2, N=1024,
    fixed draws, dropout 0, under remat "block": through the kernels and the
    plain versions (the limits of the gradient phase), then with remat off
    (the same bits). Then MAS: the card's path of an F5E-width grid equals
    the CPU's, and its time at (B=8, T_y=2304, T_x=384)."""
    from f5e_tts_tpu_torch.config import CFMConfig
    from f5e_tts_tpu_torch.models import cfm as fcfm
    from f5e_tts_tpu_torch.models.dit import init_dit
    from f5e_tts_tpu_torch.ops import mas as fmas
    from f5e_tts_tpu_torch.ops.mel import mel_spectrogram
    from f5e_tts_tpu_torch.ops.vq import gumbel_uniform
    from f5e_tts_tpu_torch.train import step as fstep
    from f5e_tts_tpu_torch.utils.text import list_str_to_bytes

    b, n = 2, 1024
    cfg = f5e_model_config()
    arch = dataclasses.replace(
        cfg.arch, depth=2, dropout=0.0,
        ppg=dataclasses.replace(cfg.arch.ppg, use_cross_mask=True),
        codebook=dataclasses.replace(cfg.arch.codebook, use_align_loss=True))
    gen = torch.Generator(device="cuda").manual_seed(9)
    params, state = init_dit(arch, 256, gen, "cuda")
    seed_modulation_(params, gen)
    params = fstep.tree_map(lambda t: t.requires_grad_(True), params)
    wav = torch.from_numpy(np.stack([speech_like(n * 256 / 24_000, seed=s) for s in (13, 14)])
                           ).float().cuda()
    mel = mel_spectrogram(wav, cfg.mel)[:, :n]
    mel_lens = torch.tensor([n, 900], device="cuda")
    text = torch.from_numpy(list_str_to_bytes(list(SENTENCES[:2]))).cuda()
    text_lens = (text >= 0).sum(dim=1)
    pd = arch.ppg.ppg_dim
    ppg = torch.randn((b, n // 2, pd), generator=gen, device="cuda")
    ppg_lens = torch.tensor([n // 2, 450], device="cuda")
    cb = arch.codebook
    shape = (b * n * cb.groups, cb.num_vars)
    draws = fixed_draws(gen, b, n, arch.mel_dim, 1, ppg=True)[0]._replace(
        ppg_keep=[torch.rand((b, n, pd), generator=gen, device="cuda") < 0.5 for _ in range(3)],
        gumbel_text=gumbel_uniform(shape, gen, "cuda"), gumbel_ppg=gumbel_uniform(shape, gen, "cuda"),
        perm_text=torch.randperm(n, generator=gen, device="cuda"),
        perm_ppg=torch.randperm(n, generator=gen, device="cuda"),
        cross_apply=torch.zeros((), device="cuda"),  # < cross_mask_prob: the cross mask acts
        cross_ratio=torch.rand(b, generator=gen, device="cuda"),
        cross_start=torch.rand(b, generator=gen, device="cuda"))
    extras = {}

    def loss_and_grads(a=arch):
        leaves = fstep.tree_leaves(params)
        for p in leaves:
            p.grad = None
        out = fcfm.cfm_loss(params, a, CFMConfig(), mel=mel, mel_lens=mel_lens, text_ids=text,
                            draws=draws, compute_dtype=torch.bfloat16, state=state,
                            text_lens=text_lens, ppg=ppg, ppg_lens=ppg_lens)
        out.loss.backward()
        extras.update(align=float(out.align_loss.detach()),
                      perplex=float(out.perplex_loss.detach()))
        return float(out.loss.detach()), [torch.zeros_like(p) if p.grad is None else
                                          p.grad.detach().clone() for p in leaves]

    tag = f"gradients F5E, 2 blocks, B={b}, N={n}, align loss and cross mask"
    # the PPG convs' biases: each conv feeds a training-mode BatchNorm
    biases = {id(c["b"]) for c in params["ppg_embed"]["convs"]}
    zero = tuple(i for i, p in enumerate(fstep.tree_leaves(params)) if id(p) in biases)
    compare_gradients(tag, loss_and_grads,
                      expected_counts(partial_rope_attention=4, partial_rope_attention_bwd=2,
                                      gated_adaln=4, gated_adaln_bwd=2), swaps, zero=zero)
    log(f"[{tag}] align loss {extras['align']:.5f}, perplexity loss {extras['perplex']:.5f}")
    if not (extras["align"] > 0 and extras["perplex"] > 0):
        raise AssertionError("the codebook losses did not act")
    loss_on, grads_on = loss_and_grads()
    check_counts("f5e remat on", read_counts(),
                 expected_counts(partial_rope_attention=4, partial_rope_attention_bwd=2,
                                 gated_adaln=4, gated_adaln_bwd=2))
    loss_off, grads_off = loss_and_grads(dataclasses.replace(arch, checkpoint_activations=False))
    check_counts("f5e remat off", read_counts(),
                 expected_counts(partial_rope_attention=2, partial_rope_attention_bwd=2,
                                 gated_adaln=2, gated_adaln_bwd=2))
    same = loss_on == loss_off and all(torch.equal(x, y) for x, y in zip(grads_on, grads_off))
    log(f"[{tag}] remat on vs off: loss {loss_on:.6f} vs {loss_off:.6f}, every gradient "
        f"bit for bit: {same}")
    if not same:
        raise AssertionError("the checkpointed blocks' loss or gradients differ from the plain blocks'")
    del grads_on, grads_off

    # MAS: the card's path equals the CPU's on a grid of this width
    with torch.no_grad():
        grid = fmas.neg_cent_grid(torch.randn((b, 384, 512), generator=gen, device="cuda"),
                                  torch.randn((b, n, 512), generator=gen, device="cuda"))
        t_ys, t_xs = torch.tensor([n, 900], device="cuda"), torch.tensor([384, 300],
                                                                          device="cuda")
        on_card = fmas.maximum_path(grid, t_ys, t_xs)
        on_host = fmas.maximum_path(grid.cpu(), t_ys.cpu(), t_xs.cpu())
        if not torch.equal(on_card.cpu(), on_host):
            raise AssertionError("maximum_path on the card differs from the CPU's")
        log(f"[mas] grid {tuple(grid.shape)}: the card's path equals the CPU's exactly "
            f"({int(on_card.sum())} cells on the path)")
        bt, ty, tx = 8, TRAIN_N, 384
        grid = fmas.neg_cent_grid(torch.randn((bt, tx, 512), generator=gen, device="cuda"),
                                  torch.randn((bt, ty, 512), generator=gen, device="cuda"))
        t_ys = torch.tensor([ty - 97 * i for i in range(bt)], device="cuda")
        t_xs = torch.tensor([tx - 31 * i for i in range(bt)], device="cuda")
        fmas.maximum_path(grid, t_ys, t_xs)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fmas.maximum_path(grid, t_ys, t_xs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        busy, launched, _ = device_busy("mas (8, 2304, 384)", lambda: fmas.maximum_path(
            grid, t_ys, t_xs))
        wall = float(np.median(walls))
        log(f"[mas] (B, T_y, T_x) = ({bt}, {ty}, {tx}): wall {wall * 1e3:.1f} ms (median of 3: "
            f"{[round(w * 1e3, 1) for w in walls]}), device busy {busy:.1f} ms in {launched} "
            f"kernels, busy share {busy / (wall * 1e3):.3f}")


def f5e_serving_phase(extractor) -> dict:
    """A TTSEngine over the full-width F5E model (seeded, bf16), the PPG of
    the reference clip from `extractor`: synthesize_chunk in the vc, tts and
    cfg modes, then cfg on an engine captured for bucket 1536 (replay bits ==
    eager bits, no launch). Each: the prompt frames equal the cond mel, the
    wav is finite and not silent; the sampler's device busy and three timed
    walls (the chunk and its decode). Returns {path: launch counts}."""
    from f5e_tts_tpu_torch.api import _cast, load_vocoder
    from f5e_tts_tpu_torch.infer import audio as faudio
    from f5e_tts_tpu_torch.infer.pipeline import TTSEngine, preprocess_ref_audio_text
    from f5e_tts_tpu_torch.models.dit import fuse_qkv, init_dit
    from f5e_tts_tpu_torch.utils.aot import capture_sampler_buckets

    cfg = f5e_model_config()
    arch = cfg.arch
    t0 = time.perf_counter()
    params, state = init_dit(arch, 256, torch.Generator(device="cuda").manual_seed(0), "cuda")
    seed_modulation_(params, torch.Generator(device="cuda").manual_seed(1))
    engine = TTSEngine(params=fuse_qkv(_cast(params, torch.bfloat16)), state=state, arch=arch,
                       vocab=None, vocoder_decode=load_vocoder(None, torch.bfloat16, "cuda", 0),
                       compute_dtype=torch.bfloat16, device="cuda")
    wav, sr = faudio.read_wav(str(reference_wav()))
    wav, ref_text = preprocess_ref_audio_text(wav, sr, REF_TEXT, show_info=lambda *_: None)
    audio, _, ref_mel = engine._reference(wav, sr)
    text = ref_text + GEN_TEXT
    ppg, ppg_lens = extractor.audio_to_ppg(faudio.resample(audio, 24_000, 16_000)[None])
    ppg = ppg.cpu().numpy()
    rf = ref_mel.shape[1]
    cond = torch.from_numpy(ref_mel[0]).cuda()
    torch.cuda.synchronize()
    log(f"[f5e serving] F5E model (dim {arch.dim}, depth {arch.depth}, {arch.heads} x "
        f"{arch.dim_head}) built in {time.perf_counter() - t0:.1f} s; reference {rf} frames, "
        f"PPG {ppg.shape} ({int(ppg_lens[0])} valid frames at 20 ms)")
    expected = expected_counts(partial_rope_attention=F5E_DEPTH * NFE,
                               gated_adaln=F5E_DEPTH * NFE)
    modes = {"vc": dict(mode="vc", alpha_spk=1.5, alpha_ppg=2.0, ppg=ppg),
             "tts": dict(mode="tts", alpha_spk=3.0, alpha_txt=3.0, ppg=ppg),
             "cfg": dict(mode="cfg", cfg_strength=2.0)}
    runs, outs = {}, {}

    def chunk(kw):
        out = engine.synthesize_chunk(ref_mel, text, FIX_FRAMES, seed=7, nfe_steps=NFE, sway=-1.0,
                                      device_out=True, **kw)[0]
        torch.cuda.synchronize()
        return out.clone()

    def check(tag, out):
        wav_out = engine.decode_mel(out[0, rf:FIX_FRAMES].float().cpu().numpy())
        rms = float(np.sqrt(np.mean(np.square(wav_out))))
        if not (tuple(out.shape) == (1, 1536, 100) and torch.equal(out[0, :rf], cond)
                and torch.isfinite(out).all() and np.isfinite(wav_out).all() and rms > 0):
            raise AssertionError(f"{tag}: prompt frames, shape or wav wrong")
        return len(wav_out), rms

    def timed(tag, kw):
        walls = []
        for _ in range(4):  # a warm-up, then three timed
            reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = chunk(kw)
            engine.decode_mel(out[0, rf:FIX_FRAMES].float().cpu().numpy())
            walls.append(time.perf_counter() - t1)
        return walls[1:], read_counts()

    for mode, kw in modes.items():
        tag = f"f5e {mode} synthesis"
        reset_counts()
        outs[mode] = chunk(kw)
        counts = runs[f"f5e_{mode}_synthesis"] = read_counts()
        check_counts(tag, counts, expected)
        samples, rms = check(tag, outs[mode])
        walls, again = timed(tag, kw)
        check_counts(f"{tag} timed", again, expected)
        busy = device_busy(f"{tag} sampler", lambda: chunk(kw))[0]
        log(f"[{tag}] {mode} mode: prompt frames {rf} equal the cond mel; wav {samples} samples "
            f"finite, rms {rms:.4f}; sampler device busy {busy:.1f} ms; wall (chunk + decode) "
            f"{[round(w, 4) for w in walls]} s, median {float(np.median(walls)):.4f} s")
        reset_counts()

    # plain CFG on a captured engine: the eager bits, no launch at replay
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    names = capture_sampler_buckets(engine, buckets=(1536,), nfe=NFE)
    torch.cuda.synchronize()
    capture = runs["f5e_captured_synthesis_capture"] = read_counts()
    log(f"[f5e captured synthesis] captured {names} in {time.perf_counter() - t0:.2f} s, "
        f"{(torch.cuda.memory_reserved() - reserved) / 2**20:.1f} MiB more reserved; launches "
        f"at capture { {k: v for k, v in capture.items() if v} }")
    check_counts("f5e captured synthesis capture", capture,
                 expected_counts(partial_rope_attention=F5E_DEPTH * (NFE + 1),
                                 gated_adaln=F5E_DEPTH * (NFE + 1)))
    replayed = chunk(modes["cfg"])
    check_counts("f5e captured synthesis replay", read_counts(), expected_counts())
    if not torch.equal(replayed, outs["cfg"]):
        raise AssertionError("the captured PPG model's replay differs from its eager run")
    check("f5e captured synthesis", replayed)
    walls, again = timed("f5e captured synthesis", modes["cfg"])
    check_counts("f5e captured synthesis timed", again, expected_counts())
    busy = device_busy("f5e captured synthesis sampler", lambda: chunk(modes["cfg"]))[0]
    log(f"[f5e captured synthesis] the replay gives the eager bits; sampler device busy "
        f"{busy:.1f} ms; wall (chunk + decode) {[round(w, 4) for w in walls]} s, median "
        f"{float(np.median(walls)):.4f} s")
    engine.engines.clear()
    reset_counts()
    return runs


# ---------------------------------------------------------------------------
# gradients through the kernels vs through their plain versions
# ---------------------------------------------------------------------------


def plain_swaps(ra, ga, ka) -> dict:
    """(module, wrapper name) -> a stand-in that runs the plain version."""
    def fwd(plain):
        return lambda *a, return_stats=False: (plain(*a), None) if return_stats else plain(*a)

    return {
        (ra, "rope_attention"): fwd(ra.rope_attention_plain),
        (ra, "rope_attention_bwd"): lambda *a: ra.rope_attention_bwd_plain(*a[:8]),
        (ga, "gated_adaln"): ga.gated_adaln_plain,
        (ga, "gated_adaln_bwd"): ga.gated_adaln_bwd_plain,
        (ka, "masked_attention"): fwd(ka.masked_attention_plain),
        (ka, "masked_attention_bwd"): lambda *a: ka.masked_attention_bwd_plain(*a[:5]),
        (ka, "joint_attention_core"): fwd(ka.joint_attention_core_plain),
        (ka, "joint_attention_core_bwd"): lambda *a: ka.joint_attention_core_bwd_plain(*a[:6])}


def compare_gradients(tag: str, loss_and_grads, expected: dict, swaps: dict,
                      zero: tuple = ()) -> None:
    """`loss_and_grads()` once through the kernels (launch counts checked) and
    once with the wrappers swapped for their plain versions (no launch). The
    gradients at the indices `zero` are zero analytically (a bias that a
    training-mode BatchNorm takes out again): rounding noise in both runs,
    with no direction to compare, they are held under ZERO_GRAD_REL x the
    largest gradient's norm instead."""
    reset_counts()
    loss_k, grads_k = loss_and_grads()
    check_counts(f"{tag} kernel run", read_counts(), expected)
    saved = {key: getattr(*key) for key in swaps}
    try:
        for (mod, name), fn in swaps.items():
            setattr(mod, name, fn)
        loss_p, grads_p = loss_and_grads()
        check_counts(f"{tag} plain run", read_counts(), expected_counts())
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos, noise = [], []
    top = max(g.double().norm().item() for g in grads_p)
    for i, (gk, gp) in enumerate(zip(grads_k, grads_p)):
        nk, np_ = gk.double().norm().item(), gp.double().norm().item()
        if i in zero:
            noise.append(max(nk, np_) / top)
            cos.append(1.0)
        elif nk == np_ == 0.0:
            cos.append(1.0)
        else:
            cos.append((gk.double() * gp.double()).sum().item() / max(nk * np_, 1e-300))
    worst = int(np.argmin(cos))
    if zero:
        log(f"[{tag}] {len(zero)} gradients zero analytically: norm at most "
            f"{max(noise):.2e} of the largest (tolerance {ZERO_GRAD_REL})")
        if max(noise) > ZERO_GRAD_REL:
            raise AssertionError(f"{tag}: a gradient that is zero analytically is not")
    log(f"[{tag}] loss kernels {loss_k:.6f} vs plain {loss_p:.6f} (relative difference "
        f"{rel:.2e}, tolerance 1e-2); gradient cosine over {len(cos)} parameters: min "
        f"{cos[worst]:.6f} (tensor {worst}, shape {tuple(grads_k[worst].shape)}), median "
        f"{float(np.median(cos)):.6f} (tolerance 0.99)")
    if not math.isfinite(loss_k) or not rel <= 1e-2 or min(cos) < 0.99:
        raise AssertionError(f"{tag}: the kernels' loss or gradients disagree with the plain versions")


# a gradient that is zero analytically is a sum over B x N rows of bf16
# cotangents that cancel: rounding noise (1.9e-4 of the largest gradient's
# norm at a tiny width on the CPU, 3.3e-5 at full width on the card);
# 1e-2 still tells noise from a gradient
ZERO_GRAD_REL = 1e-2


def gradient_phase(swaps: dict) -> None:
    """cfm_loss and all gradients of a 2-block Base-width DiT."""
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

    compare_gradients(f"gradients DiT, 2 blocks, B={b}, N={n}", loss_and_grads,
                      expected_counts(rope_attention=2, rope_attention_bwd=2, gated_adaln=2,
                                      gated_adaln_bwd=2), swaps)


MMDIT_GRAD_SHAPE = (2, 1024, 96)  # B, N, Nt of the masked MMDiT gradient phase


def mmdit_gradient_phase(swaps: dict) -> dict:
    """A masked MSE through backbone.forward_train of a 2-block full-width
    MMDiT *with* a padding mask, the one path to K8: cfm_loss passes no mask."""
    from f5e_tts_tpu_torch.config import MMDiTConfig
    from f5e_tts_tpu_torch.models import backbone as fbb
    from f5e_tts_tpu_torch.models.mmdit import init_mmdit
    from f5e_tts_tpu_torch.train import step as fstep
    from f5e_tts_tpu_torch.utils.masks import lens_to_mask

    b, n, nt = MMDIT_GRAD_SHAPE
    arch = MMDiTConfig(depth=2)
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = init_mmdit(arch, 256, gen, "cuda")
    seed_modulation_(params, gen)
    params = fstep.tree_map(lambda t: t.requires_grad_(True), params)
    x, cond, target = (torch.randn((b, n, arch.mel_dim), generator=gen, device="cuda")
                       for _ in range(3))
    text = torch.randint(0, 256, (b, nt), generator=gen, device="cuda")
    text[1, 70:] = -1
    time_ = torch.rand(b, generator=gen, device="cuda")
    mask = lens_to_mask(torch.tensor([n, 900], device="cuda"), n)
    drop = torch.zeros(b, dtype=torch.bool, device="cuda")

    def loss_and_grads():
        leaves = fstep.tree_leaves(params)
        for p in leaves:
            p.grad = None
        pred = fbb.forward_train(params, arch, x=x.bfloat16(), cond=cond.bfloat16(),
                                 text_ids=text, time=time_, drop_audio_cond=drop, drop_text=drop,
                                 mask=mask, compute_dtype=torch.bfloat16)
        w = mask[:, :, None].float()
        loss = ((pred - target).square() * w).sum() / (w.sum() * arch.mel_dim)
        loss.backward()
        return float(loss.detach()), [p.grad.detach().clone() for p in leaves]

    expected = expected_counts(joint_attention=2, joint_attention_bwd=2)
    compare_gradients(f"gradients MMDiT, 2 blocks, B={b}, N={n}, Nt={nt}, masked", loss_and_grads,
                      expected, swaps)
    return expected


# ---------------------------------------------------------------------------
# one phase per kernel
# ---------------------------------------------------------------------------


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, ops_s, bytes_s,
               library_ms, also=None) -> dict:
    """One row of the kernels line. `launches` is {path: launches in one run
    of it}; the row's `launches` is the first path's."""
    bound_s = max(ops_s, bytes_s)
    row = {"name": name, "route": "cuda", "source": f"f5e_tts_tpu_torch/csrc/{source}.cu",
           "replaces": replaces, "launches": next(iter(launches.values())),
           "launches_by_path": launches, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
           "bound_by": "operations" if ops_s >= bytes_s else "bytes", "library_ms": library_ms}
    if also:
        row["also"] = also
    log(f"[{name}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms "
        f"({row['bound_by']}), library {library_ms if library_ms is None else round(library_ms, 4)} ms")
    return row


class AttentionCase:
    """Operands of one attention kernel at one shape, with the kernel, its
    plain version and the library call (SDPA with the equivalent boolean key
    mask, q/k pre-rotated where the kernel rotates) as closures.
    kind: "rope" (rope_heads of the heads rotated, prefix mask), "masked"
    (prefix mask) or "joint" (lens are audio lengths, n_audio given)."""

    def __init__(self, mods, kind, b, n, lens, gen, rope_heads=0, n_audio=None, h=16, dh=64):
        from f5e_tts_tpu_torch.ops.rope import rot_half, rotary_cos_sin_half

        ra, ka = mods
        self.kind, self.b, self.n, self.h, self.dh = kind, b, n, h, dh
        self.lens_list, self.n_audio, self.rope = list(lens), n_audio, kind == "rope"
        # q, k, v as column slices of a fused projection's output where the
        # model has one (the DiT's to_qkv); the MMDiT concatenates its streams
        if kind == "rope":
            qkv = torch.randn((b, n, 3 * h * dh), generator=gen, device="cuda").bfloat16()
            q, k, v = (t.unflatten(-1, (h, dh)) for t in qkv.chunk(3, dim=-1))
        else:
            q, k, v = (torch.randn((b, n, h, dh), generator=gen, device="cuda").bfloat16()
                       for _ in range(3))
        self.g = torch.randn((b, n, h, dh), generator=gen, device="cuda").bfloat16()
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        col = torch.arange(n, device="cuda")
        if kind == "rope":
            cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(dh, n))
            self.fwd = lambda **kw: ra.rope_attention(q, k, v, lens_t, cos, sin, rope_heads, **kw)
            self.plain = lambda: ra.rope_attention_plain(q, k, v, lens_t, cos, sin, rope_heads)
            self.bwd = lambda out, stats: ra.rope_attention_bwd(q, k, v, lens_t, cos, sin, self.g,
                                                                rope_heads, out, stats)
            self.bwd_plain = lambda: ra.rope_attention_bwd_plain(q, k, v, lens_t, cos, sin,
                                                                 self.g, rope_heads)
            c, s = cos[None, :, None, :], sin[None, :, None, :]
            rotated = (torch.arange(h, device="cuda") < rope_heads)[None, None, :, None]
            lib_q, lib_k = (torch.where(rotated, t.float() * c + rot_half(t.float()) * s,
                                        t.float()).bfloat16() for t in (q, k))
        elif kind == "masked":
            self.fwd = lambda **kw: ka.masked_attention(q, k, v, lens_t, **kw)
            self.plain = lambda: ka.masked_attention_plain(q, k, v, lens_t)
            self.bwd = lambda out, stats: ka.masked_attention_bwd(q, k, v, lens_t, self.g, out,
                                                                  stats)
            self.bwd_plain = lambda: ka.masked_attention_bwd_plain(q, k, v, lens_t, self.g)
            lib_q, lib_k = q, k
        else:
            self.fwd = lambda **kw: ka.joint_attention_core(q, k, v, lens_t, n_audio, **kw)
            self.plain = lambda: ka.joint_attention_core_plain(q, k, v, lens_t, n_audio)
            self.bwd = lambda out, stats: ka.joint_attention_core_bwd(q, k, v, lens_t, n_audio,
                                                                      self.g, out, stats)
            self.bwd_plain = lambda: ka.joint_attention_core_bwd_plain(q, k, v, lens_t, n_audio,
                                                                       self.g)
            lib_q, lib_k = q, k
        valid = col[None, :] < lens_t[:, None]
        if kind == "joint":
            valid = valid | (col >= n_audio)[None, :]
        # keys each sample's rows attend to; a row with none averages all n
        self.keys = sum(int(x) if int(x) > 0 else n for x in valid.sum(dim=-1).tolist())
        self.key_mask = None if bool(valid.all()) else valid[:, None, None, :]
        self.lib = tuple(t.transpose(1, 2).detach() for t in (lib_q, lib_k, v))

    def library(self):
        q, k, v = self.lib
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=self.key_mask)

    def library_backward(self):
        """A callable running the backward of the library call through autograd."""
        q, k, v = (t.detach().requires_grad_() for t in self.lib)
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=self.key_mask)
        gt = self.g.transpose(1, 2)
        return lambda: torch.autograd.grad(o, (q, k, v), gt, retain_graph=True)

    def bound(self, backward: bool):
        """(operation seconds, byte seconds): the 2 (forward) or 5 (backward)
        N x keys x dh products over the valid keys; q, k, v, out (forward) or
        q, k, v, g, dq, dk, dv (backward), the tables and the lengths."""
        flops = (10.0 if backward else 4.0) * self.h * self.dh * self.n * self.keys
        nbytes = (7 if backward else 4) * self.b * self.n * self.h * self.dh * 2 + self.b * 4
        if self.rope:
            nbytes += 2 * self.n * self.dh * 4
        return flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES

    def describe(self) -> str:
        extra = f", n_audio {self.n_audio}" if self.n_audio is not None else ""
        return f"({self.b}, {self.n}, {self.h}, {self.dh}), lens {self.lens_list}{extra}"


# (part, kernel-name fragment) of one forward and one backward call
FWD_PARTS = (("pre-pass", "attention_fwd_prep_kernel"), ("main", "attention_fwd_kernel"))
BWD_PARTS = (("pre-pass", "attention_bwd_prep_kernel"), ("dq", "attention_bwd_dq_kernel"),
             ("dkdv", "attention_bwd_dkdv_kernel"))
# the two passes of one K5 call
K5_PARTS = (("row pass", "gated_adaln_bwd_kernel"), ("combine", "gated_adaln_bwd_reduce_kernel"))


def kernel_split(tag: str, fn, parts, calls: int = 4) -> dict:
    """Device ms of each kernel of one call `fn()`, by `parts`: the mean over
    `calls` calls in one torch.profiler run (as `profile_run` reads it), and
    their sum. The calls queue behind ~10 ms of device sleep: a profiler run
    can miss the kernels launched as it starts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    split = {}
    for part, frag in parts:
        found = [e for e in kernels if frag in e.key]
        launched = sum(e.count for e in found)
        split[part] = sum(e.self_device_time_total for e in found) / max(launched, 1) / 1e3
    split["total"] = sum(split.values())
    if min(split.values()) <= 0:
        log(f"[{tag}] torch.profiler saw no device time of some kernel: split not "
            f"measured ({len(kernels)} device kernels seen: {[e.key[:48] for e in kernels[:4]]})")
        return None
    log(f"[{tag}] mean of {calls} calls under torch.profiler: " +
        ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
    return split


def adaln_bwd_operands(seed: int = 6, d: int = 1024):
    """K5's operands at the training step's shape (width d): x, y, gate,
    scale, g_newx, g_out, with gate and scale column slices of the (B, 6D)
    modulation."""
    b, n = TRAIN_CLIPS, TRAIN_N
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, y, g_newx, g_out = (torch.randn((b, n, d), generator=gen, device="cuda").bfloat16()
                           for _ in range(4))
    mod = torch.randn((b, 6 * d), generator=gen, device="cuda").bfloat16()
    return x, y, mod[:, 2 * d:3 * d], mod[:, 4 * d:5 * d], g_newx, g_out


def split_phase(mods, ga):
    """K1's, K4's and K5's device time by kernel at the training shape T,
    measured before the model phases: in a profiled window this short late in
    the run the profiler saw no device kernel at all."""
    case = AttentionCase(mods, "rope", TRAIN_CLIPS, TRAIN_N, (TRAIN_N,) * TRAIN_CLIPS,
                         torch.Generator(device="cuda").manual_seed(7), rope_heads=16)
    out, stats = case.fwd(return_stats=True)
    adaln = adaln_bwd_operands()
    return (kernel_split("forward split", case.fwd, FWD_PARTS),
            kernel_split("backward split", lambda: case.bwd(out, stats), BWD_PARTS),
            kernel_split("gated_adaln_bwd split", lambda: ga.gated_adaln_bwd(*adaln), K5_PARTS))


def attention_kernel_phase(name, source, replaces, launches, backward, cases, iters=24,
                           split=None) -> dict:
    """Kernel vs plain at every case (the first is the path's shape and gives
    the row's numbers; the others are checked, and timed when `timed`), then
    the times; `split` (device ms by kernel of one call) goes into the row's
    `also`, and so does a forward's host time per call at the first case.
    cases: [(tag, make_case, timed)]."""
    err, numbers = 0.0, {}
    for tag, make_case, timed in cases:
        case = make_case()
        out, stats = case.fwd(return_stats=True)
        if backward:
            got = case.bwd(out, stats)
            torch.cuda.synchronize()
            ref = case.bwd_plain()
            for part, x, y in zip(("dq", "dk", "dv"), got, ref):
                err = max(err, check_close_rel(f"{name} {tag} {part}", x, y, BWD_REL))
            again = case.bwd(out, stats)  # no atomics: the same bits
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name} {tag}: two backward runs differ")
            del got, ref, again
        else:
            torch.cuda.synchronize()
            err = max(err, check_close(f"{name} {tag}", out, case.plain()))
        if timed:
            torch.cuda.empty_cache()
            extra = {}
            if backward:
                ms = cuda_ms([lambda: case.bwd(out, stats)], iters=8)
                plain_ms = cuda_ms([case.bwd_plain], iters=4, warmup=1)
                torch.cuda.empty_cache()
                library_ms = cuda_ms([case.library_backward()], iters=8)
            else:
                # one input set: the kernels do hundreds of flops per byte, so
                # where their operands come from barely matters
                ms = cuda_ms([case.fwd], iters=iters)
                plain_ms = cuda_ms([case.plain], iters=max(iters // 4, 4), warmup=1)
                library_ms = cuda_ms([case.library], iters=iters)
                extra["host_us"] = host_us(case.fwd)
            ops_s, bytes_s = case.bound(backward)
            numbers[tag] = {"shape": case.describe(), "ms": ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "bound_ms": max(ops_s, bytes_s) * 1e3,
                            "bound_share": max(ops_s, bytes_s) * 1e3 / ms,
                            **extra, "ops_s": ops_s, "bytes_s": bytes_s}
            log(f"[{name} {tag}] {case.describe()}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {library_ms:.4f} ms, bound {max(ops_s, bytes_s) * 1e3:.4f} ms" +
                (f", host {extra['host_us']:.1f} us a call" if extra else ""))
        del case, out, stats
        torch.cuda.empty_cache()
    first, *rest = numbers.items()
    main = first[1]
    also = {tag: {k: v for k, v in d.items() if k not in ("ops_s", "bytes_s")} for tag, d in rest}
    if "host_us" in main:
        also["host_us_per_call"] = main["host_us"]
    if split is not None:
        also["device_ms_by_kernel"] = split
    return kernel_row(name, source, replaces, launches, err, main["ms"], main["plain_ms"],
                      main["ops_s"], main["bytes_s"], main["library_ms"], also or None)


def attention_rows(mods, paths: dict, text_len: int, splits) -> list:
    """The rows of the ten attention kernels. paths: {counter name: {path:
    launches}}; text_len: Nt of the MMDiT training batch; splits: from
    `split_phase`, K1's and K4's device ms by kernel first, each None where
    not measured."""
    k1_split, k4_split = splits[:2]
    gen = torch.Generator(device="cuda").manual_seed(2)
    h = 16

    def case(kind, b, n, lens, **kw):
        return lambda: AttentionCase(mods, kind, b, n, lens, gen, **kw)

    synth, train_b = (2, 1536, (1416, 1100)), (TRAIN_CLIPS, TRAIN_N, (TRAIN_N,) * TRAIN_CLIPS)
    ragged_b = (2, TRAIN_N, (TRAIN_N, 1337))
    # the UNetT's time token makes N+1 rows: (2, 1537) in E2 synthesis (the
    # synthesis shape's lengths plus one), (8, 2305) in its training step
    e2_synth = (2, 1537, (1417, 1101))
    e2_train = (TRAIN_CLIPS, TRAIN_N + 1, (TRAIN_N + 1,) * TRAIN_CLIPS)
    gb, gn, gnt = MMDIT_GRAD_SHAPE
    mm_n = TRAIN_N + text_len  # the MMDiT training step's joint length
    both = lambda a, b: {"synthesis": a, "training_step": b}  # noqa: E731
    # every launch of the RoPE kernel, on all or some heads, is one of the
    # packed TPU kernels' function (the two count disjoint paths)
    fwd_all = {**paths["rope_attention"], **paths["partial_rope_attention"]}
    bwd_all = {**paths["rope_attention_bwd"], **paths["partial_rope_attention_bwd"]}
    rows = []
    with torch.inference_mode():
        rows.append(attention_kernel_phase(
            "rope_attention", "rope_attention", f"{PALLAS}:523", paths["rope_attention"], False,
            [("synthesis", case("rope", *synth, rope_heads=h), True),
             ("training", case("rope", *train_b, rope_heads=h), True),
             # the serving batcher's batch of 4: 8 folded rows, four key lengths
             ("batched synthesis", case("rope", 8, 1536, SERVE_FRAMES * 2, rope_heads=h), True)],
            split=k1_split))
        rows.append(attention_kernel_phase(
            "partial_rope_attention", "rope_attention", f"{PALLAS}:183",
            paths["partial_rope_attention"], False,
            [("synthesis", case("rope", *synth, rope_heads=1), True),
             ("training", case("rope", *train_b, rope_heads=1), True),
             ("e2 synthesis", case("rope", *e2_synth, rope_heads=1), True),
             # the keys of E2 synthesis, but nine full 192-row query tiles: as
             # slow as 1537 rows if the one-row last tile costs a whole tile
             ("nine full tiles", case("rope", 2, 9 * 192, e2_synth[2], rope_heads=1), True),
             # the F5E model: 12 heads
             ("f5e synthesis", case("rope", *synth, rope_heads=1, h=12), True),
             ("f5e ragged", case("rope", 3, 200, (200, 57, 0), rope_heads=1, h=12), False)]))
        rows.append(attention_kernel_phase(
            "joint_attention", "joint_attention", f"{PALLAS}:1201", paths["joint_attention"], False,
            [("synthesis", case("joint", 2, 1536 + 128, (1416, 1100), n_audio=1536), True),
             ("ragged", case("joint", 3, 200 + 32, (0, 200, 57), n_audio=200), False)]))
        rows.append(attention_kernel_phase(
            "masked_attention", "masked_attention", f"{PALLAS}:86", paths["masked_attention"],
            False,
            [("training", case("masked", TRAIN_CLIPS, mm_n, (mm_n,) * TRAIN_CLIPS), True),
             ("ragged", case("masked", 2, mm_n, (mm_n, 1337)), False)]))
        rows.append(attention_kernel_phase(
            "packed_rope_attention", "rope_attention", f"{PALLAS}:312", fwd_all, False,
            [("synthesis", case("rope", *synth, rope_heads=h), True)]))
    torch.cuda.empty_cache()
    rows.append(attention_kernel_phase(
        "rope_attention_bwd", "rope_attention", f"{PALLAS}:567", paths["rope_attention_bwd"], True,
        [("training", case("rope", *train_b, rope_heads=h), True),
         ("ragged", case("rope", *ragged_b, rope_heads=h), False)], split=k4_split))
    rows.append(attention_kernel_phase(
        "partial_rope_attention_bwd", "rope_attention", f"{PALLAS}:906",
        paths["partial_rope_attention_bwd"], True,
        [("training", case("rope", *train_b, rope_heads=1), True),
         ("ragged", case("rope", *ragged_b, rope_heads=1), False),
         ("e2 training", case("rope", *e2_train, rope_heads=1), True),
         ("f5e training", case("rope", *train_b, rope_heads=1, h=12), True),
         ("f5e ragged", case("rope", *ragged_b, rope_heads=1, h=12), False)]))
    rows.append(attention_kernel_phase(
        "joint_attention_bwd", "joint_attention", f"{PALLAS}:1298", paths["joint_attention_bwd"],
        True,
        [("gradient phase", case("joint", gb, gn + gnt, (gn, 900), n_audio=gn), True),
         ("training shape", case("joint", TRAIN_CLIPS, TRAIN_N + 128,
                                 (TRAIN_N, 2000, 1337, TRAIN_N, 900, 0, 2303, 64),
                                 n_audio=TRAIN_N), True)]))
    rows.append(attention_kernel_phase(
        "masked_attention_bwd", "masked_attention", f"{PALLAS}:770", paths["masked_attention_bwd"],
        True,
        [("training", case("masked", TRAIN_CLIPS, mm_n, (mm_n,) * TRAIN_CLIPS), True),
         ("ragged", case("masked", 2, mm_n, (mm_n, 1337)), False)]))
    rows.append(attention_kernel_phase(
        "packed_rope_attention_bwd", "rope_attention", f"{PALLAS}:458", bwd_all, True,
        [("training", case("rope", *train_b, rope_heads=h), True)]))
    return rows


def adaln_case(ga, b: int, n: int, d: int, tag: str) -> dict:
    """K2 against its plain version at (b, n, d), then both timed: kernel,
    plain and the bound (x, y read once, new_x, out written once, ~11 fp32
    flops an element)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, y = (torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    gate, scale, shift = (torch.randn((b, d), generator=gen, device="cuda").to(torch.bfloat16)
                          for _ in range(3))
    new_x, out = ga.gated_adaln(x, y, gate, scale, shift)
    torch.cuda.synchronize()
    ref_x, ref_out = ga.gated_adaln_plain(x, y, gate, scale, shift)
    err = max(check_close(f"gated_adaln {tag} new_x", new_x, ref_x),
              check_close(f"gated_adaln {tag} out", out, ref_out))
    # timed over 4 input sets (~100 MB with outputs at D = 1024, twice the
    # L2): the kernel is bound by memory, and the bound counts device-memory bytes
    sets = [(x, y)] + [tuple(torch.randn((b, n, d), generator=gen, device="cuda")
                             .to(torch.bfloat16) for _ in range(2)) for _ in range(3)]
    ms = cuda_ms([lambda a=a, c=c: ga.gated_adaln(a, c, gate, scale, shift) for a, c in sets])
    plain_ms = cuda_ms([lambda a=a, c=c: ga.gated_adaln_plain(a, c, gate, scale, shift)
                        for a, c in sets])
    ops_s = 11.0 * b * n * d / PEAK_FP32_FLOPS
    bytes_s = (4 * b * n * d * 2 + 3 * b * d * 2) / PEAK_BYTES
    bound = max(ops_s, bytes_s) * 1e3
    log(f"[gated_adaln {tag}] ({b}, {n}, {d}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({bound / ms:.2f} of it)")
    return {"shape": f"({b}, {n}, {d})", "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_share": bound / ms, "ops_s": ops_s, "bytes_s": bytes_s}


def adaln_phase(ga, launches: dict) -> dict:
    """K2 at the v1 synthesis shape (the row's numbers), at the F5E
    model's D = 768 and at the serving batcher's batch of 4 (8 folded rows;
    both in `also`)."""
    main = adaln_case(ga, 2, 1536, 1024, "synthesis")
    more = {"f5e synthesis": adaln_case(ga, 2, 1536, 768, "f5e synthesis"),
            "batched synthesis": adaln_case(ga, 8, 1536, 1024, "batched synthesis")}
    also = {tag: {k: v for k, v in case.items() if k not in ("ops_s", "bytes_s")}
            for tag, case in more.items()}
    also["bound_share"] = main["bound_share"]
    return kernel_row("gated_adaln", "gated_adaln", "f5e_tts_tpu/ops/pallas_norm.py:38", launches,
                      max(c["err"] for c in (main, *more.values())), main["ms"],
                      main["plain_ms"], main["ops_s"], main["bytes_s"], None, also)


def adaln_bwd_case(ga, d: int, tag: str, host: bool = False) -> dict:
    """K5 against its plain version at the training step's (8, 2304, d),
    two runs the same bits, then kernel and plain timed (x, y, g_newx, g_out
    read once, dx, dy written once, the (B, d) operands and sums once; ~20
    fp32 flops an element); with `host` its wrapper's host time a call."""
    args = adaln_bwd_operands(d=d)
    b, n, _ = args[0].shape
    got = ga.gated_adaln_bwd(*args)
    torch.cuda.synchronize()
    ref = ga.gated_adaln_bwd_plain(*args)
    err = max(check_close(f"gated_adaln_bwd {tag} {name}", a, r) for name, a, r in
              zip(("dx", "dy", "dgate", "dscale", "dshift"), got, ref))
    again = ga.gated_adaln_bwd(*args)  # no atomics: the same bits
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"gated_adaln_bwd {tag}: two runs differ")
    log(f"[gated_adaln_bwd {tag}] two runs give the same bits")
    del got, ref, again
    # one input set: 4 inputs and 2 outputs of 28-38 MB each, over 3x the L2
    ms = cuda_ms([lambda: ga.gated_adaln_bwd(*args)])
    plain_ms = cuda_ms([lambda: ga.gated_adaln_bwd_plain(*args)])
    ops_s = 20.0 * b * n * d / PEAK_FP32_FLOPS
    bytes_s = (6 * b * n * d * 2 + 5 * b * d * 2) / PEAK_BYTES
    bound = max(ops_s, bytes_s) * 1e3
    out = {"shape": f"({b}, {n}, {d})", "err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_share": bound / ms, "ops_s": ops_s, "bytes_s": bytes_s}
    if host:
        out["host_us_per_call"] = host_us(lambda: ga.gated_adaln_bwd(*args))
    log(f"[gated_adaln_bwd {tag}] ({b}, {n}, {d}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({bound / ms:.2f} of it)" +
        (f", host {out['host_us_per_call']:.1f} us a call" if host else ""))
    return out


def adaln_bwd_phase(ga, launches: dict, split) -> dict:
    """K5 at the training step's shape (the row's numbers, its wrapper's host
    time a call and `split`, the device ms of its row pass and combine from
    `split_phase`) and at the F5E model's D = 768 (in `also`)."""
    main = adaln_bwd_case(ga, 1024, "training", host=True)
    f5e = adaln_bwd_case(ga, 768, "f5e training")
    also = {"host_us_per_call": main["host_us_per_call"], "bound_share": main["bound_share"],
            "f5e training": {k: v for k, v in f5e.items() if k not in ("ops_s", "bytes_s")}}
    if split is not None:
        also["device_ms_by_kernel"] = split
    return kernel_row("gated_adaln_bwd", "gated_adaln", "f5e_tts_tpu/ops/pallas_norm.py:159",
                      launches, max(main["err"], f5e["err"]), main["ms"], main["plain_ms"],
                      main["ops_s"], main["bytes_s"], None, also)


def build_report(libs: dict, ra) -> None:
    """Each kernel's registers, spills and static shared memory from ptxas's
    report in the build logs, and the dynamic shared memory of the forward's
    main kernel and the backward's kernels from the library."""
    for name, path in libs.items():
        build_log = path.with_name(path.name + ".log")
        kernel = None
        for line in build_log.read_text().splitlines() if build_log.exists() else []:
            found = re.search(r"Function properties for (\S+)", line)
            if found:
                mangled = found.group(1).split("_cu_", 1)[-1]  # past the source's name
                parts = re.findall(r"(attention_[a-z_]*kernel|gated_adaln[a-z_]*|ILi\d+E|"
                                   r"RopeAttn|MaskedAttn|JointAttn)", mangled)
                kernel = " ".join(p.strip("ILiE") if p.startswith("ILi") else p
                                  for p in parts) or mangled[:60]
            elif kernel and "spill" in line:
                log(f"[build] {name}: {kernel}: {line.strip()}")
            elif kernel and "registers" in line:
                log(f"[build] {name}: {kernel}: {line.split(':', 1)[-1].strip()}")
    for dh in (64, 128):
        log(f"[build] dynamic shared memory at dh {dh}: forward main kernel "
            f"{ra._lib().attention_smem(dh, 0)} bytes, backward dq kernel "
            f"{ra._lib().attention_smem(dh, 1)} bytes, dkdv kernel "
            f"{ra._lib().attention_smem(dh, 2)} bytes")


# ---------------------------------------------------------------------------
# serving: EPSS grids, captured engines, device-resident decode, streaming
# ---------------------------------------------------------------------------

EPSS_KEEP = (0, 1, 2, 3, 4, 6, 10, 18, 32)  # the 8-of-32 grid of scripts/quality_proxy.py
EPSS_NFE = len(EPSS_KEEP) - 1
FIX_FRAMES = int(FIX_DURATION * 24_000 / 256)


class Serving:
    """One full-width preset model (F5TTS_v1_Base unless named) for the
    serving phases, its reference, and the sampler inputs of its one-chunk
    request."""

    def __init__(self, model: str = "F5TTS_v1_Base", depth: int = DEPTH, tag: str = "serving"):
        from f5e_tts_tpu_torch.infer import audio as faudio
        from f5e_tts_tpu_torch.infer.pipeline import preprocess_ref_audio_text
        from f5e_tts_tpu_torch.models.cfm import pruned_sway_timesteps

        self.tts = preset_tts(tag, model, depth)
        self.engine = self.tts.engine
        self.ref = str(reference_wav())
        self.grid = pruned_sway_timesteps(EPSS_KEEP, base_steps=NFE)
        wav, sr = faudio.read_wav(self.ref)
        self.wav, self.sr = wav, sr
        wav, ref_text = preprocess_ref_audio_text(wav, sr, REF_TEXT, show_info=lambda *_: None)
        self.ref_mel = self.engine._reference(wav, sr)[2]
        self.text = ref_text + GEN_TEXT
        self.sampler_busy: dict = {}  # nfe -> (eager, replayed) device busy ms (captured phase)

    def infer(self, timesteps=None):
        return self.tts.infer(self.ref, REF_TEXT, GEN_TEXT, nfe_step=NFE, cfg_strength=2.0,
                              sway_sampling_coef=-1.0, fix_duration=FIX_DURATION, seed=7,
                              timesteps=timesteps)

    def sampler_out(self, timesteps=None, eager=False, engine=None) -> torch.Tensor:
        """The sampler output (1, 1536, 100) of the request's chunk on
        `engine` (this model's unless given), replayed where a captured
        engine matches unless `eager`."""
        engine = engine or self.engine
        engines = engine.engines
        if eager:
            engine.engines = {}
        try:
            out = engine.synthesize_chunk(self.ref_mel, self.text, FIX_FRAMES, seed=7,
                                          nfe_steps=NFE, cfg_strength=2.0, sway=-1.0,
                                          timesteps=timesteps, device_out=True)[0]
            torch.cuda.synchronize()
            return out.clone()
        finally:
            engine.engines = engines

    def sampler_inputs(self):
        """(SamplerInputs, sampler keywords) of the request's chunk, as
        synthesize_chunk hands them to cfm.sample (one eager run, recorded)."""
        from f5e_tts_tpu_torch.models import cfm as fcfm

        seen, sample = [], fcfm.sample

        def recording(params, arch, cfm, inputs, **kw):
            seen.append((inputs, kw))
            return sample(params, arch, cfm, inputs, **kw)

        fcfm.sample = recording
        try:
            self.sampler_out(eager=True)
        finally:
            fcfm.sample = sample
        reset_counts()
        return seen[0]


def device_busy(tag: str, fn) -> tuple:
    """(device busy ms, device kernels, {kernel name: launches}) of one call
    of `fn` under torch.profiler, behind ~10 ms of device sleep (a profiler
    run can miss the kernels launched as it starts), the sleep not counted.
    Busy is the union of the kernels' intervals (`busy_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = busy_ms(kernels)
    conv = [e for e in kernels if "fprop" in e.name]
    log(f"[{tag}] device busy {busy:.1f} ms (kernel time {kernel_ms(kernels):.1f} ms) in "
        f"{len(kernels)} device kernels; the convolution's {len(conv)}: kernel time "
        f"{kernel_ms(conv):.1f} ms, busy {busy_ms(conv):.1f} ms on "
        f"{len({e.device_resource_id for e in conv})} stream(s)")
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0) + 1
    return busy, len(kernels), by_kernel


def epss_phase(sv: Serving) -> dict:
    """F5TTS.infer on the EPSS grid; then the full keep set against the
    default 32-step run, bit for bit."""
    from f5e_tts_tpu_torch.models.cfm import pruned_sway_timesteps

    counts = synthesis_phase("epss synthesis", lambda: sv.infer(sv.grid),
                             expected_counts(rope_attention=DEPTH * EPSS_NFE,
                                             gated_adaln=DEPTH * EPSS_NFE),
                             runs=3, timesteps=sv.grid)
    full = sv.infer(pruned_sway_timesteps(range(NFE + 1), base_steps=NFE))
    default = sv.infer()
    reset_counts()
    if not (np.array_equal(full[0], default[0]) and np.array_equal(full[2], default[2])):
        raise AssertionError("the full keep set range(33) differs from the default 32-step run")
    log("[epss synthesis] the full keep set range(33) gives the default run's wav and mel bits")
    return counts


def captured_phase(sv: Serving) -> dict:
    """Capture the v1 sampler of bucket 1536 at NFE 32 and on the EPSS grid,
    hold replays against the eager sampler, profile one replay, and time
    warm syntheses on each engine; returns the launch counts of the
    captures (a replay counts none)."""
    from f5e_tts_tpu_torch.utils.aot import capture_sampler_buckets

    engine = sv.engine
    reset_counts()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    names = capture_sampler_buckets(engine, buckets=(1536,), nfe=NFE)
    names += capture_sampler_buckets(engine, buckets=(1536,), timesteps=sv.grid)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    steps = NFE + 1 + EPSS_NFE + 1  # each engine's loop and its warm-up step
    log(f"[captured synthesis] captured {names} in {seconds:.2f} s; memory reserved "
        f"{(torch.cuda.memory_reserved() - reserved) / 2**20:.1f} MiB more (the shared pool "
        f"and the static buffers); launches counted at capture "
        f"{ {k: v for k, v in counts.items() if v} }")
    check_counts("captured synthesis capture", counts,
                 expected_counts(rope_attention=DEPTH * steps, gated_adaln=DEPTH * steps))

    for timesteps, nfe in ((None, NFE), (sv.grid, EPSS_NFE)):
        tag = f"captured synthesis nfe {nfe}"
        replayed = sv.sampler_out(timesteps)
        check_counts(f"{tag} replay", read_counts(), expected_counts())
        eager = sv.sampler_out(timesteps, eager=True)
        check_counts(f"{tag} eager", read_counts(),
                     expected_counts(rope_attention=DEPTH * nfe, gated_adaln=DEPTH * nfe))
        if not torch.equal(replayed, eager):
            diff = (replayed.float() - eager.float()).abs().max().item()
            raise AssertionError(f"{tag}: replay differs from the eager sampler (max {diff})")
        log(f"[{tag}] the replay from the eager run's noise gives its bits")
        sv.sampler_busy[nfe] = (
            device_busy(f"{tag} eager sampler", lambda: sv.sampler_out(timesteps, eager=True))[0],
            device_busy(f"{tag} replayed sampler", lambda: sv.sampler_out(timesteps))[0])
        reset_counts()

    graph = engine.engines[names[0]].graph
    _, _, by_kernel = device_busy("captured synthesis one replay", graph.replay)
    seen = {part: sum(c for k, c in by_kernel.items() if frag in k)
            for part, frag in (("K1 pre-pass", "attention_fwd_prep_kernel"),
                               ("K1 main", "attention_fwd_kernel"),
                               ("K2", "gated_adaln_kernel"))}
    log(f"[captured synthesis] one profiled replay: {seen}")
    if any(c != DEPTH * NFE for c in seen.values()):
        raise AssertionError(f"one replay ran {seen}, expected {DEPTH * NFE} of each")

    for timesteps, nfe in ((None, NFE), (sv.grid, EPSS_NFE)):
        tag = f"captured synthesis nfe {nfe}"
        walls = []
        for run in ["warm-up"] + [f"timed {i + 1}" for i in range(3)]:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav, sr, mel = sv.infer(timesteps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_counts(f"{tag} {run}", read_counts(), expected_counts())
            log(f"[{tag}] {run}: wall {wall:.3f} s")
            if run != "warm-up":
                walls.append(wall)
        engines, engine.engines = engine.engines, {}
        eager_wav = sv.infer(timesteps)[0]
        engine.engines = engines
        reset_counts()
        if not (np.isfinite(wav).all() and np.sqrt(np.mean(np.square(wav))) > 0):
            raise AssertionError(f"{tag}: non-finite or silent wav")
        if not np.array_equal(wav, eager_wav):
            raise AssertionError(f"{tag}: the wav differs from the eager run's")
        audio_s = len(wav) / sr
        wall = float(np.median(walls))
        log(f"[{tag}] wav {audio_s:.3f} s, the eager run's bits; one warm synthesis (median "
            f"of 3): wall {wall:.3f} s, RTF {wall / audio_s:.5f}; RTF of each: "
            f"{[round(w / audio_s, 5) for w in walls]}")
        profile_run(f"{tag} profile", lambda: sv.infer(timesteps), wall)
    reset_counts()
    return counts


def e2_captured_phase(sv: Serving) -> dict:
    """Capture the E2 sampler of bucket 1536 at NFE 32 (a UNetT: attention on
    N+1 = 1537 rows, RoPE tables 1537 long); a replay from the eager run's
    noise gives its bits; the sampler's device time eager and replayed, and
    three timed warm syntheses on the engine whose wav is the eager run's.
    Returns the launch counts of the capture."""
    from f5e_tts_tpu_torch.utils.aot import capture_sampler_buckets

    engine = sv.engine
    eager = sv.sampler_out(eager=True)
    check_counts("e2 captured synthesis eager", read_counts(),
                 expected_counts(partial_rope_attention=E2_DEPTH * NFE))
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    names = capture_sampler_buckets(engine, buckets=(1536,), nfe=NFE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    log(f"[e2 captured synthesis] captured {names} in {seconds:.2f} s; memory reserved "
        f"{(torch.cuda.memory_reserved() - reserved) / 2**20:.1f} MiB more; launches counted at "
        f"capture { {k: v for k, v in counts.items() if v} }")
    check_counts("e2 captured synthesis capture", counts,
                 expected_counts(partial_rope_attention=E2_DEPTH * (NFE + 1)))
    replayed = sv.sampler_out()
    check_counts("e2 captured synthesis replay", read_counts(), expected_counts())
    if not torch.equal(replayed, eager):
        diff = (replayed.float() - eager.float()).abs().max().item()
        raise AssertionError(f"e2: the replay differs from the eager sampler (max {diff})")
    log("[e2 captured synthesis] the replay from the eager run's noise gives its bits")
    device_busy("e2 eager sampler", lambda: sv.sampler_out(eager=True))
    device_busy("e2 replayed sampler", sv.sampler_out)
    reset_counts()

    walls = []
    for run in ["warm-up"] + [f"timed {i + 1}" for i in range(3)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav, sr, _ = sv.infer()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_counts(f"e2 captured synthesis {run}", read_counts(), expected_counts())
        if run != "warm-up":
            walls.append(wall)
    engines, engine.engines = engine.engines, {}
    eager_wav = sv.infer()[0]
    engine.engines = engines
    reset_counts()
    if not (np.isfinite(wav).all() and np.array_equal(wav, eager_wav)):
        raise AssertionError("e2: the captured synthesis' wav differs from the eager run's")
    wall, audio_s = float(np.median(walls)), len(wav) / sr
    log(f"[e2 captured synthesis] wav {audio_s:.3f} s, the eager run's bits; one warm synthesis "
        f"(median of 3): wall {wall:.3f} s, RTF {wall / audio_s:.5f}; RTF of each: "
        f"{[round(w / audio_s, 5) for w in walls]}")
    profile_run("e2 captured synthesis profile", sv.infer, wall)
    reset_counts()
    return counts


# alpha_spk = alpha_txt = 1 + cfg gives the TTS sampler plain CFG's branch
# weights; the outputs differ only by the bf16 GEMMs of a 3B batch against a
# 2B one. The relative L2 distance of the generated frames must stay under
# TTS_REL (PERF.md §6 states why).
TTS_REL = 2e-2


def tts_mode_phase(sv: Serving) -> dict:
    """synthesize_chunk(mode="tts", alpha_spk = alpha_txt = 1 + cfg) on the
    serving v1 model against plain-CFG sample(cfg) from the same noise; the
    two samplers' device time."""
    cfg = 2.0

    def tts():
        out = sv.engine.synthesize_chunk(sv.ref_mel, sv.text, FIX_FRAMES, seed=7, nfe_steps=NFE,
                                         sway=-1.0, mode="tts", alpha_spk=1 + cfg,
                                         alpha_txt=1 + cfg, device_out=True)[0]
        torch.cuda.synchronize()
        return out.clone()

    reset_counts()
    plain = sv.sampler_out(eager=True)
    check_counts("tts mode plain cfg", read_counts(),
                 expected_counts(rope_attention=DEPTH * NFE, gated_adaln=DEPTH * NFE))
    got = tts()
    counts = read_counts()
    check_counts("tts mode", counts,
                 expected_counts(rope_attention=DEPTH * NFE, gated_adaln=DEPTH * NFE))
    rf = sv.ref_mel.shape[1]
    gen_t, gen_p = got[0, rf:FIX_FRAMES].float(), plain[0, rf:FIX_FRAMES].float()
    rel = ((gen_t - gen_p).norm() / gen_p.norm()).item()
    max_abs = (gen_t - gen_p).abs().max().item()
    log(f"[tts mode] alpha_spk = alpha_txt = {1 + cfg} vs plain cfg {cfg}: generated frames "
        f"{FIX_FRAMES - rf}, relative L2 {rel:.3e} (tolerance {TTS_REL}), max|diff| "
        f"{max_abs:.3e} of max|plain| {gen_p.abs().max().item():.3e}; bitwise "
        f"{torch.equal(got, plain)}")
    if not (torch.isfinite(got).all() and torch.equal(got[0, :rf], plain[0, :rf])
            and rel <= TTS_REL):
        raise AssertionError("tts mode with equal alphas disagrees with plain CFG")
    busy_tts = device_busy("tts mode sampler (3 branches)", tts)[0]
    busy_cfg = sv.sampler_busy[NFE][0]  # the same request's eager sampler (captured phase)
    log(f"[tts mode] sampler device busy {busy_tts:.1f} ms vs {busy_cfg:.1f} ms: "
        f"{busy_tts / busy_cfg:.3f}x")
    reset_counts()
    return counts


EDIT_TEXT = ("Some call me nature, and in the quiet hours before dawn by the lake, "
             "others call me mother nature.")


def speech_edit_phase(sv: Serving, parts=((1.0, 2.0),), tag: str = "speech edit") -> dict:
    """edit_speech on the serving v1 model: the span `parts` of the seeded
    reference (1.0-2.0 s unless given) re-timed to 10 s (bucket 1536). Every
    kept frame of the sampler output equals the cond mel; the wav is finite."""
    from f5e_tts_tpu_torch.infer.speech_edit import edit_speech
    from f5e_tts_tpu_torch.models import cfm as fcfm

    captured, sample = [], fcfm.sample

    def recording_sample(params, arch, cfm, inputs, **kw):
        out = sample(params, arch, cfm, inputs, **kw)
        captured.append((out[0], inputs))
        return out

    fcfm.sample = recording_sample
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav, sr = edit_speech(sv.engine, sv.wav, sv.sr, REF_TEXT, EDIT_TEXT, list(parts),
                              fix_durations=[10.0], seed=7, nfe_steps=NFE, cfg_strength=2.0,
                              sway=-1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        fcfm.sample = sample
    check_counts(tag, counts,
                 expected_counts(rope_attention=DEPTH * NFE, gated_adaln=DEPTH * NFE))
    (out, inputs), = captured
    n = int(inputs.duration[0])
    keep = inputs.cond_mask[:, :, None].expand_as(out)
    if tuple(out.shape) != (1, 1536, 100) or not torch.equal(out[keep], inputs.cond[keep]):
        raise AssertionError(f"{tag}: a kept frame differs from the cond mel")
    edited = int((~inputs.cond_mask[0, :n]).sum())
    if not (0 < edited < n and np.isfinite(wav).all() and np.sqrt(np.mean(wav ** 2)) > 0):
        raise AssertionError(f"{tag}: {edited} of {n} frames edited, or a bad wav")
    log(f"[{tag}] span(s) {[tuple(round(x, 3) for x in p) for p in parts]}: {n} frames in "
        f"bucket 1536, {edited} generated, {n - edited} kept equal to the cond mel bit for bit; "
        f"wav {len(wav) / sr:.3f} s finite; wall {wall:.3f} s")
    reset_counts()
    return counts


def decode_stream_phase(sv: Serving) -> None:
    """The device-resident decode against the host decode of the same mel,
    and a streamed request against the same request in one piece."""
    from f5e_tts_tpu_torch.infer.pipeline import slice_gen

    engine = sv.engine
    rf = sv.ref_mel.shape[1]
    out = sv.sampler_out()
    gl = FIX_FRAMES - rf
    mel_dev = slice_gen(out, torch.tensor([rf], device="cuda"), torch.tensor([gl], device="cuda"),
                        gl)
    wav_dev, trim = engine.decode_mel(mel_dev, device_out=True)
    wav_dev = wav_dev[0, :trim].float().cpu().numpy()
    wav_host = engine.decode_mel(out[0, rf:FIX_FRAMES].float().cpu().numpy())
    if not np.array_equal(wav_dev, wav_host):
        raise AssertionError("the device-resident decode differs from the host decode")
    log(f"[device decode] {gl} generated frames: the device-resident decode gives the host "
        f"decode's {len(wav_host)} samples bit for bit")

    kw = dict(seed=7, fix_duration=FIX_DURATION, nfe_steps=NFE, cfg_strength=2.0, sway=-1.0)
    wav, _, _ = engine.infer(sv.wav, sv.sr, REF_TEXT, GEN_TEXT, **kw)
    pieces = [p for p, _ in engine.infer(sv.wav, sv.sr, REF_TEXT, GEN_TEXT, streaming=True,
                                         chunk_size=4096, **kw)]
    reset_counts()
    if not (all(len(p) == 4096 for p in pieces[:-1]) and np.array_equal(np.concatenate(pieces),
                                                                       wav)):
        raise AssertionError("the streamed pieces do not concatenate to the wav")
    log(f"[streaming] {len(pieces)} pieces of <= 4096 samples concatenate to the "
        f"{len(wav)}-sample wav")


# ---------------------------------------------------------------------------
# the PPG front end's own life cycle: PPG engines, offline extraction, ASR
# training, streaming, recognition; the derived-span edit; the training CLI
# ---------------------------------------------------------------------------

ASR_VOCAB = 5000  # DecoderConfig()'s vocab, shared by the CTC head
# the card's fp32 values against the CPU's on the same inputs: max|card -
# cpu| <= ASR_REL * |cpu| for a loss, <= ASR_REL * max|cpu| for the streamed
# encoder output (fp32 sums in another order through 12 layers; TF32 off)
ASR_REL = 1e-4
# a greedy search may take another token on the card only where the CPU's
# top two logits are closer than this
TIE_MARGIN = 1e-4
PPG_BUCKETS = (400, 800, 1600, 3200)


def clips_16k() -> list:
    """The 8 training clips resampled to 16 kHz (185.6 s)."""
    from f5e_tts_tpu_torch.infer.audio import resample

    return [resample(r["audio"]["array"], 24_000, 16_000) for r in training_rows()]


def padded_batch(clips) -> tuple:
    lens = np.asarray([len(c) for c in clips], np.int64)
    wav = np.zeros((len(clips), int(lens.max())), np.float32)
    for i, c in enumerate(clips):
        wav[i, : len(c)] = c
    return wav, lens


def conformer_to_wenet(params, cfg) -> dict:
    """A wenet ASR checkpoint's state dict (the keys and layouts
    `conformer_from_torch` reads) from port Conformer params."""
    sd = {}

    def cpu(t):
        return t.detach().float().cpu().contiguous()

    def lin(k, p):
        sd[f"{k}.weight"] = cpu(p["w"].T)
        if "b" in p:
            sd[f"{k}.bias"] = cpu(p["b"])

    def ln(k, p):
        sd[f"{k}.weight"], sd[f"{k}.bias"] = cpu(p["g"]), cpu(p["b"])

    for i, conv in enumerate(params["embed_convs"]):
        sd[f"encoder.embed.conv.{2 * i}.weight"] = cpu(conv["w"].permute(3, 2, 0, 1))
        sd[f"encoder.embed.conv.{2 * i}.bias"] = cpu(conv["b"])
    lin("encoder.embed.out.0", params["embed_out"])
    sd["encoder.global_cmvn.mean"] = cpu(params["cmvn_mean"])
    sd["encoder.global_cmvn.istd"] = cpu(params["cmvn_istd"])
    for i, layer in enumerate(params["layers"]):
        k = f"encoder.encoders.{i}"
        for name in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff", "norm_final"):
            ln(f"{k}.{name}", layer[name])
        for src, dst in (("ff_macaron", "feed_forward_macaron"), ("ff", "feed_forward")):
            lin(f"{k}.{dst}.w_1", layer[src]["w1"])
            lin(f"{k}.{dst}.w_2", layer[src]["w2"])
        for name in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            lin(f"{k}.self_attn.{name}", layer["attn"][name])
        sd[f"{k}.self_attn.pos_bias_u"] = cpu(layer["attn"]["pos_bias_u"])
        sd[f"{k}.self_attn.pos_bias_v"] = cpu(layer["attn"]["pos_bias_v"])
        cm, conv = f"{k}.conv_module", layer["conv"]
        sd[f"{cm}.pointwise_conv1.weight"] = cpu(conv["pw1"]["w"].T[:, :, None])
        sd[f"{cm}.pointwise_conv1.bias"] = cpu(conv["pw1"]["b"])
        sd[f"{cm}.depthwise_conv.weight"] = cpu(conv["dw"]["w"].permute(2, 1, 0))
        sd[f"{cm}.depthwise_conv.bias"] = cpu(conv["dw"]["b"])
        sd[f"{cm}.pointwise_conv2.weight"] = cpu(conv["pw2"]["w"].T[:, :, None])
        sd[f"{cm}.pointwise_conv2.bias"] = cpu(conv["pw2"]["b"])
        for src, dst in (("g", "weight"), ("b", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")):
            sd[f"{cm}.norm.{dst}"] = cpu(conv["bn"][src])
    ln("encoder.after_norm", params["after_norm"])
    lin("linear", params["content_linear"])
    return sd


def ppg_engines_phase(extractor) -> None:
    """capture_ppg_buckets over the four fbank buckets of the F5E extractor:
    the capture's seconds and memory; a replay of each clip padded into its
    bucket equals eager mel_to_ppg bit for bit; the replay's and the eager
    call's device time per second of audio."""
    from f5e_tts_tpu_torch.ops.kaldi import kaldi_fbank
    from f5e_tts_tpu_torch.utils.aot import capture_ppg_buckets, find_ppg_engine

    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    engines = capture_ppg_buckets(extractor, PPG_BUCKETS)
    torch.cuda.synchronize()
    log(f"[ppg engines] captured {sorted(engines)} in {time.perf_counter() - t0:.2f} s; memory "
        f"reserved {(torch.cuda.memory_reserved() - reserved) / 2**20:.1f} MiB more")
    clips = clips_16k()
    for seconds in (3.5, 7.5, 15.0, 21.9):  # 348 to 2188 frames: each bucket once
        clip = torch.from_numpy(clips[0][: int(seconds * 16_000)]).cuda()
        feats = kaldi_fbank(clip)
        frames = feats.shape[1]
        name, bucket = find_ppg_engine(engines, 1, frames)
        padded = torch.zeros((1, bucket, 80), device="cuda")
        padded[:, :frames] = feats
        lens = torch.tensor([frames], dtype=torch.int32, device="cuda")
        ppg, true_len = engines[name].run(padded, lens)
        want, want_len = extractor.mel_to_ppg(padded, lens)
        if not (torch.equal(ppg, want) and torch.equal(true_len, want_len)):
            raise AssertionError(f"ppg engine {name}: the replay differs from eager mel_to_ppg")
        # one launch a replay, so CUDA events time its device work; the eager
        # call is host-bound, so its device time is the profiler's busy time
        replay = cuda_ms([lambda: engines[name].graph.replay()], iters=10, warmup=2)
        eager, launched, _ = device_busy(f"ppg engines eager {name}",
                                         lambda: extractor.mel_to_ppg(padded, lens))
        log(f"[ppg engines] {seconds} s clip ({frames} frames) in {name}: replay == eager bit "
            f"for bit ({int(true_len[0])} PPG frames); device {replay:.3f} ms a replay, "
            f"{replay / seconds:.4f} ms per second of audio; eager device busy {eager:.3f} ms "
            f"in {launched} kernels ({eager / seconds:.4f} ms/s); the bucket pads "
            f"{bucket - frames} frames")
    del engines


def offline_extraction_phase(extractor, tmp: Path) -> None:
    """ppg_extract_cli.main over a filelist of four written 16 kHz wavs with
    the F5E extractor's weights as a wenet checkpoint: every .npy has
    true_len rows and equals audio_to_ppg of its padded file within 1e-5."""
    import yaml

    from f5e_tts_tpu_torch.infer.audio import read_wav, write_wav
    from f5e_tts_tpu_torch.models import ppg_extract_cli

    cfg = extractor.cfg
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(conformer_to_wenet(extractor.params, cfg), tmp / "33.pt")
    (tmp / "train.yaml").write_text(yaml.safe_dump({
        "input_dim": cfg.input_dim, "encoder_conf": {
            "output_size": cfg.output_size, "attention_heads": cfg.attention_heads,
            "linear_units": cfg.linear_units, "num_blocks": cfg.num_blocks,
            "cnn_module_kernel": cfg.cnn_module_kernel, "input_layer": cfg.subsampling}}))
    paths = []
    for i, seconds in enumerate((1.7, 3.2, 4.9, 6.05)):
        paths.append(str(tmp / f"clip{i}.wav"))
        write_wav(paths[-1], speech_like(seconds, 16_000, seed=20 + i).astype(np.float32), 16_000)
    (tmp / "wavs.txt").write_text("\n".join(paths) + "\n")
    t0 = time.perf_counter()
    ppg_extract_cli.main(["--ckpt", str(tmp / "33.pt"), "--config", str(tmp / "train.yaml"),
                          "--filelist", str(tmp / "wavs.txt"), "--output_dir", str(tmp / "out"),
                          "--device", "cuda"])
    wall = time.perf_counter() - t0
    worst = 0.0
    for path in paths:
        got = np.load(tmp / "out" / (Path(path).stem + ".npy"))
        wav, _ = read_wav(path)
        padded = np.zeros(-(-len(wav) // 32_000) * 32_000, np.float32)
        padded[: len(wav)] = wav
        want, true_len = extractor.audio_to_ppg(torch.from_numpy(padded[None]).cuda(),
                                                torch.tensor([len(wav)], device="cuda"))
        want = want[0, : int(true_len[0])].cpu().numpy()
        if got.shape != want.shape or not np.abs(got - want).max() <= 1e-5:
            raise AssertionError(f"offline extraction of {path}: {got.shape} vs {want.shape}")
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"[offline extraction] {len(paths)} wavs -> .npy of {[int(np.load(tmp / 'out' / (Path(p).stem + '.npy')).shape[0]) for p in paths]} "
        f"rows in {wall:.2f} s (checkpoint load included); max|cli - audio_to_ppg| {worst:.2e}")
    shutil.rmtree(tmp, ignore_errors=True)


def asr_batch(cfg, gen_np) -> dict:
    """The 8 clips at 16 kHz as kaldi fbank on the card, with seeded frame
    labels (-1 past each length) and CTC labels (60-100 tokens of 1-4999)."""
    from f5e_tts_tpu_torch.models.conformer import subsampled_time
    from f5e_tts_tpu_torch.ops.kaldi import kaldi_fbank

    wav, lens = padded_batch(clips_16k())
    feats = kaldi_fbank(torch.from_numpy(wav).cuda())
    feat_lens = np.maximum((lens - 400) // 160 + 1, 0).astype(np.int32)
    tt = subsampled_time(cfg.subsampling, feats.shape[1])
    out_lens = np.asarray([subsampled_time(cfg.subsampling, int(n)) for n in feat_lens])
    frame_labels = gen_np.integers(0, ASR_VOCAB + 1, (len(lens), tt))
    frame_labels[np.arange(tt)[None, :] >= out_lens[:, None]] = -1
    ctc_lens = gen_np.integers(60, 101, len(lens))
    ctc_labels = gen_np.integers(1, ASR_VOCAB, (len(lens), 100))
    ctc_labels[np.arange(100)[None, :] >= ctc_lens[:, None]] = 0
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    return {"feats": feats, "feat_lens": cuda(feat_lens), "frame_labels": cuda(frame_labels),
            "ctc_labels": cuda(ctc_labels), "ctc_label_lens": cuda(ctc_lens),
            "seconds": float(lens.sum() / 16_000)}


def asr_training_phase() -> dict:
    """The PPG ASR model at full width (ConformerConfig(), CE + CTC heads of
    5000 tokens, fp32): three make_asr_train_step updates with AdamW, each
    with a sample_train_chunk_mask; the first step's loss on the card equals
    the CPU's at the same weights within ASR_REL. Then asr_loss with the
    softmax speaker branch, backpropagated, and the GRL check, and
    attention_loss of DecoderConfig(r_num_blocks=3) over the encoder output,
    backpropagated. Returns the trained encoder, heads and decoder."""
    from f5e_tts_tpu_torch.models import wenet_decoder as wd
    from f5e_tts_tpu_torch.models.conformer import (ConformerConfig, conformer_encode,
                                                    init_conformer, sample_train_chunk_mask)
    from f5e_tts_tpu_torch.models.conformer_train import (asr_loss, init_asr_heads,
                                                          init_sv_branch, make_asr_train_step)
    from f5e_tts_tpu_torch.train import step as fstep

    cfg = ConformerConfig()
    gen = torch.Generator(device="cuda").manual_seed(31)
    params = init_conformer(cfg, gen, "cuda")
    params["cmvn_mean"] = 8.0 + torch.randn(cfg.input_dim, generator=gen, device="cuda")
    params["cmvn_istd"] = 0.25 + 0.1 * torch.rand(cfg.input_dim, generator=gen, device="cuda")
    heads = init_asr_heads(cfg, ASR_VOCAB, gen, "cuda")
    rng = np.random.default_rng(32)
    batch = asr_batch(cfg, rng)
    mask_rng = np.random.default_rng(30)  # draws chunks of 9 and 7 frames, then the full context
    t_frames = batch["feats"].shape[1]
    optimizer = fstep.AdamW(lambda count: 1e-4, max_grad_norm=1.0)
    leaves = fstep.tree_leaves([params, heads])
    opt_state = optimizer.init(leaves)
    step = make_asr_train_step(cfg, optimizer)
    n_params = sum(t.numel() for t in leaves)
    log(f"[asr training] Conformer {cfg.num_blocks} x {cfg.output_size}, {cfg.attention_heads} "
        f"heads, heads of {ASR_VOCAB} tokens: {n_params / 1e6:.2f}M fp32 params; fbank "
        f"{tuple(batch['feats'].shape)} of {batch['seconds']:.1f} s")
    walls, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(3):
        mask = sample_train_chunk_mask(cfg, t_frames, mask_rng)
        batch["chunk_mask"] = torch.from_numpy(mask).cuda()
        if i == 0:
            host = fstep.tree_map(lambda t: t.detach().cpu(), [params, heads])
            with torch.no_grad():
                ref = asr_loss(host[0], host[1], cfg, **{
                    k: v.cpu() for k, v in batch.items() if torch.is_tensor(v)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, heads, opt_state, out = step(params, heads, opt_state, batch)
        loss = float(out.loss)
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"[asr training] step {i + 1}: chunk mask {'full' if mask.all() else 'chunked'}, "
            f"loss {loss:.5f} (CE {float(out.ce_loss):.5f}, CTC {float(out.ctc_loss):.5f}, "
            f"acc {float(out.acc):.4f}), wall {walls[-1]:.3f} s")
        if i == 0:
            rel = abs(loss - float(ref.loss)) / abs(float(ref.loss))
            log(f"[asr training] step 1 loss on the card {loss:.6f}, on the CPU "
                f"{float(ref.loss):.6f}: relative difference {rel:.2e} (tolerance {ASR_REL})")
            if not rel <= ASR_REL:
                raise AssertionError("the card's ASR loss disagrees with the CPU's")
            del host, ref
        if not math.isfinite(loss):
            raise AssertionError("a non-finite ASR loss")
    peak = torch.cuda.max_memory_allocated()
    check_counts("asr training", read_counts(), expected_counts())
    wall = float(np.median(walls[1:]))
    log(f"[asr training] warm step wall {wall:.3f} s (median of "
        f"{[round(w, 4) for w in walls[1:]]}), {batch['seconds'] / wall:.0f} s of audio per "
        f"second; peak memory {peak / 2**30:.2f} GiB")
    profile_run("asr training profile", lambda: step(params, heads, opt_state, batch), wall)

    # the speaker branch through the GRL: the encoder's gradient of the SV loss
    # with the reversal is the negative of the one without it (coeff -1)
    sv = init_sv_branch(cfg, 8, gen, sv_loss="softmax", device="cuda")
    spk = torch.arange(batch["feats"].shape[0], device="cuda")
    enc_leaves = fstep.tree_leaves(params)
    kw = dict(sv_params=sv, spk_label=spk, sv_weight=0.5, **{
        k: v for k, v in batch.items() if torch.is_tensor(v) and k != "chunk_mask"})
    out = asr_loss(params, heads, cfg, **kw)
    grads = torch.autograd.grad(out.loss, enc_leaves, allow_unused=True)
    if not (math.isfinite(float(out.loss.detach())) and all(
            torch.isfinite(g).all() for g in grads if g is not None)):
        raise AssertionError("asr_loss with the speaker branch is not finite")
    flipped = [torch.autograd.grad(asr_loss(params, heads, cfg, grl_coeff=c, **kw).sv_loss,
                                   enc_leaves, allow_unused=True) for c in (1.0, -1.0)]
    pairs = [(a, b) for a, b in zip(*flipped) if a is not None]
    worst = max(float((a + b).abs().max()) for a, b in pairs)
    top = max(float(b.abs().max()) for _, b in pairs)
    log(f"[asr training] speaker branch: loss {float(out.loss.detach()):.5f}, SV "
        f"{float(out.sv_loss.detach()):.5f} "
        f"(acc {float(out.sv_acc):.3f}); the encoder's SV gradient with the GRL vs without: "
        f"max|g_grl + g_plain| {worst:.3e} of max|g| {top:.3e} over {len(pairs)} tensors")
    if not (top > 0 and worst <= ASR_REL * top):
        raise AssertionError("the GRL does not flip the encoder's gradient")
    del grads, flipped, pairs

    dcfg = wd.DecoderConfig(r_num_blocks=3)
    dec = wd.init_decoder(dcfg, gen, "cuda")
    dec_leaves = fstep.tree_leaves(dec)
    for p in dec_leaves:
        p.requires_grad_(True)
    b = batch["feats"].shape[0]
    ys = rng.integers(3, ASR_VOCAB - 1, (b, 40))
    ys[np.arange(40)[None, :] >= rng.integers(10, 41, b)[:, None]] = wd.IGNORE_ID
    enc, enc_lens = conformer_encode(params, cfg, batch["feats"], batch["feat_lens"])
    att, acc = wd.attention_loss(dec, dcfg, enc, enc_lens, ys, ASR_VOCAB - 1, ASR_VOCAB - 1,
                                 reverse_weight=0.3)
    g_dec = torch.autograd.grad(att, dec_leaves + enc_leaves, allow_unused=True)
    n_grads = sum(g is not None for g in g_dec)
    if not (math.isfinite(float(att.detach())) and all(torch.isfinite(g).all() for g in g_dec
                                              if g is not None)):
        raise AssertionError("attention_loss or its gradients are not finite")
    log(f"[asr training] attention_loss of DecoderConfig(r_num_blocks=3) over the encoder: "
        f"{float(att.detach()):.5f} (accuracy {float(acc):.4f}), {n_grads} finite gradients "
        f"(decoder and encoder)")
    for p in enc_leaves + fstep.tree_leaves(heads) + dec_leaves:
        p.requires_grad_(False)
    reset_counts()
    return {"cfg": cfg, "params": params, "heads": heads, "dcfg": dcfg, "dec": dec}


def streaming_phase(asr) -> None:
    """conformer_encode_chunk_by_chunk on a 10 s clip, decoding chunk 16,
    left chunks -1 and 4, on the card against the CPU (ASR_REL * max|y|);
    device time per chunk and the streamed decode's RTF."""
    from f5e_tts_tpu_torch.models.conformer import conformer_encode_chunk_by_chunk
    from f5e_tts_tpu_torch.ops.kaldi import kaldi_fbank
    from f5e_tts_tpu_torch.train import step as fstep

    cfg, params = asr["cfg"], asr["params"]
    host = fstep.tree_map(lambda t: t.cpu(), params)
    feats = kaldi_fbank(torch.from_numpy(clips_16k()[1][:160_000]).cuda())
    with torch.no_grad():
        for left in (-1, 4):
            def run():
                return conformer_encode_chunk_by_chunk(params, cfg, feats, 16, left)

            y = run()
            ref = conformer_encode_chunk_by_chunk(host, cfg, feats.cpu(), 16, left)
            err, top = float((y.cpu() - ref).abs().max()), float(ref.abs().max())
            chunks = -(-y.shape[1] // 16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"[streaming] 10 s clip, chunk 16, left chunks {left}: output "
                f"{tuple(y.shape)} in {chunks} chunks; card vs CPU max|diff| {err:.3e} of "
                f"max|y| {top:.3e}; wall {wall:.3f} s: RTF {wall / 10.0:.4f}")
            if left == -1:  # one profile (~10 s of the run's time): left 4 runs as many kernels
                busy, launched, _ = device_busy(f"streaming, left chunks {left}", run)
                log(f"[streaming] left chunks {left}: device busy {busy / chunks:.3f} ms a chunk "
                    f"({launched / chunks:.0f} kernels), busy share {busy / (wall * 1e3):.3f}")
            if not (torch.isfinite(y).all() and err <= ASR_REL * top):
                raise AssertionError("the card's streamed encoding disagrees with the CPU's")
    check_counts("streaming", read_counts(), expected_counts())


def recognition_phase(asr) -> None:
    """recognize in the ctc_greedy_search mode (a fresh CTC head) and the
    attention mode (the decoder of the training phase) on the card and on
    the CPU, on two 10 s clips: equal token lists, or the CPU's top-two
    logit margin under TIE_MARGIN where they first differ."""
    from f5e_tts_tpu_torch.models import wenet_decoder as wd
    from f5e_tts_tpu_torch.models.conformer import PPGExtractor, conformer_encode
    from f5e_tts_tpu_torch.models.wenet_tools import recognize
    from f5e_tts_tpu_torch.ops import nn as fnn
    from f5e_tts_tpu_torch.ops.kaldi import kaldi_fbank
    from f5e_tts_tpu_torch.train import step as fstep

    from f5e_tts_tpu_torch.models.conformer_train import init_asr_heads

    cfg = asr["cfg"]
    card = PPGExtractor(params=asr["params"], cfg=cfg, device="cuda")
    host = PPGExtractor(params=fstep.tree_map(lambda t: t.cpu(), asr["params"]), cfg=cfg,
                        device="cpu")
    wav, lens = padded_batch([c[:160_000] for c in clips_16k()[-2:]])
    feats = kaldi_fbank(torch.from_numpy(wav)).numpy()
    feat_lens = np.maximum((lens - 400) // 160 + 1, 0)
    # a fresh CTC head: three steps have taught the trained one to emit only
    # blanks, which would leave the greedy search nothing to compare
    card_ctc = init_asr_heads(cfg, ASR_VOCAB, torch.Generator(device="cuda").manual_seed(33),
                              "cuda")["ctc"]
    ctc = fstep.tree_map(lambda t: t.cpu(), card_ctc)
    dec = fstep.tree_map(lambda t: t.cpu(), asr["dec"])
    eos = ASR_VOCAB - 1
    enc, enc_lens = conformer_encode(host.params, cfg, torch.from_numpy(feats),
                                     torch.from_numpy(feat_lens))
    for mode, kw in (("ctc_greedy_search", dict(ctc_params=ctc)),
                     ("attention", dict(decoder_params=dec, decoder_cfg=asr["dcfg"], sos=eos,
                                        eos=eos, max_len=100))):
        t0 = time.perf_counter()
        got = recognize(card, feats, feat_lens, mode=mode, **kw)
        wall = time.perf_counter() - t0
        want = recognize(host, feats, feat_lens, mode=mode, **kw)
        log(f"[recognition] {mode}: {[len(h) for h in got]} tokens on the card in {wall:.2f} s, "
            f"{[len(h) for h in want]} on the CPU; equal: {got == want}")
        for row, (g, w) in enumerate(zip(got, want)):
            if g == w:
                continue
            i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
            with torch.no_grad():
                if mode == "attention":
                    ys = torch.tensor([[eos] + w[:i]])
                    logits = wd.decoder_forward(dec, asr["dcfg"], enc[row:row + 1],
                                                enc_lens[row:row + 1], ys,
                                                torch.tensor([ys.shape[1]]))[0][0, -1]
                else:  # the first frame whose argmax differs
                    host_lg = fnn.linear(ctc, enc[row, : int(enc_lens[row])])
                    card_enc, _ = conformer_encode(card.params, cfg,
                                                   torch.from_numpy(feats[row:row + 1]).cuda(),
                                                   torch.from_numpy(feat_lens[row:row + 1]).cuda())
                    card_lg = fnn.linear(card_ctc, card_enc[0, : int(enc_lens[row])]).cpu()
                    frames = (card_lg.argmax(-1) != host_lg.argmax(-1)).nonzero()
                    logits = host_lg[int(frames[0])] if len(frames) else None
            if logits is None:  # no frame's argmax differs: no tie explains it
                margin = math.inf
            else:
                top2 = torch.topk(logits.float(), 2).values
                margin = float(top2[0] - top2[1])
            log(f"[recognition] {mode} row {row}: first difference at step {i}, the CPU's "
                f"top-two logit margin there {margin:.3e} (limit {TIE_MARGIN})")
            if not margin < TIE_MARGIN:
                raise AssertionError(f"recognize ({mode}) on the card differs from the CPU")
    check_counts("recognition", read_counts(), expected_counts())


def derived_span_edit_phase(sv, asr) -> dict:
    """Speech editing with spans derived on the card: the trained CTC head's
    log-probs over the v1 reference at 16 kHz, forced-aligned to the bytes
    of its transcript, give the span of "mother" (derive_edit_spans); the
    spans equal the CPU's, and edit_speech over them runs as the speech edit
    phase checks it (depth x NFE of K1 and K2, kept frames == cond mel)."""
    from f5e_tts_tpu_torch.infer.audio import resample
    from f5e_tts_tpu_torch.infer.speech_edit import derive_edit_spans
    from f5e_tts_tpu_torch.models.conformer import conformer_encode
    from f5e_tts_tpu_torch.ops import nn as fnn
    from f5e_tts_tpu_torch.ops.kaldi import kaldi_fbank
    from f5e_tts_tpu_torch.train import step as fstep

    cfg = asr["cfg"]
    feats = kaldi_fbank(torch.from_numpy(resample(sv.wav, sv.sr, 16_000)).cuda())
    tokens = list(REF_TEXT.encode("utf-8"))
    i0 = REF_TEXT.index("mother")
    ranges = [(i0, i0 + len("mother") - 1)]

    def spans(params, ctc, dev):
        with torch.no_grad():
            enc, lens = conformer_encode(params, cfg, feats.to(dev),
                                         torch.tensor([feats.shape[1]], device=dev))
            lp = torch.log_softmax(fnn.linear(ctc, enc[0, : int(lens[0])]).float(), dim=-1)
        return derive_edit_spans(lp, tokens, ranges, 0.02), lp.shape[0]

    t0 = time.perf_counter()
    got, frames = spans(asr["params"], asr["heads"]["ctc"], "cuda")
    align_s = time.perf_counter() - t0
    want, _ = spans(fstep.tree_map(lambda t: t.cpu(), asr["params"]),
                    fstep.tree_map(lambda t: t.cpu(), asr["heads"]["ctc"]), "cpu")
    log(f"[derived-span edit] {len(tokens)} byte tokens over {frames} CTC frames (20 ms): the "
        f"span of 'mother' {got} on the card ({align_s:.2f} s with the alignment), {want} on "
        f"the CPU")
    if got != want:
        raise AssertionError("the spans derived on the card differ from the CPU's")
    return speech_edit_phase(sv, parts=got, tag="derived-span edit")


def training_cli_phase(tmp: Path) -> dict:
    """train.main over configs/example.yaml with the byte tokenizer, the
    codebook off, a save directory under `tmp` and bnb_optimizer on, and an
    Arrow dataset of the
    8 clips in the {name}_byte layout: two updates, each launching 2 x depth
    K3 and K2 and depth K6 and K5 (remat "block"); the 8-bit state under 0.3x
    the fp32 AdamW state's bytes; a second main() resumes at update 3.
    Returns the launch counts of one step."""
    import yaml
    from datasets import Dataset as ArrowDataset

    from f5e_tts_tpu_torch.train import train as cli
    from f5e_tts_tpu_torch.train import trainer as ftrainer
    from f5e_tts_tpu_torch.train.adamw8bit import state_bytes
    from f5e_tts_tpu_torch.train.step import tree_leaves

    shutil.rmtree(tmp, ignore_errors=True)
    raw = yaml.safe_load((ROOT / "configs" / "example.yaml").read_text())
    raw["model"]["tokenizer"] = "byte"
    raw["datasets"]["name"] = "smoke"
    raw["optim"]["bnb_optimizer"] = True
    raw["ckpts"]["save_dir"] = str(tmp / "ckpts")
    # the CLI builds its Trainer without a PPG extractor, so its batches carry
    # no PPG lengths, and the codebook branch needs them: the JAX CLI fails
    # its assert on example.yaml as it is (f5e_tts_tpu/models/dit.py:500), the
    # port's raises the same way (tests/test_torch_train_cli.py); so the
    # codebook is off here and the PPG DiT trains on zero PPG, as the JAX CLI
    # trains any use_ppg YAML without a codebook
    raw["model"]["use_codebook"] = False
    config = tmp / "example_byte.yaml"
    ds_dir = tmp / "data" / "smoke_byte"
    ds_dir.mkdir(parents=True)
    config.write_text(yaml.safe_dump(raw))
    t0 = time.perf_counter()
    rows = training_rows()
    ArrowDataset.from_list(rows).save_to_disk(str(ds_dir / "raw"))
    (ds_dir / "duration.json").write_text(json.dumps({"duration": [r["duration"] for r in rows]}))
    log(f"[training cli] YAML {config.name} (example.yaml, byte tokenizer, bnb_optimizer, no "
        f"codebook) and "
        f"an Arrow dataset of {len(rows)} clips written in {time.perf_counter() - t0:.1f} s")
    expected = expected_counts(partial_rope_attention=2 * F5E_DEPTH,
                               partial_rope_attention_bwd=F5E_DEPTH,
                               gated_adaln=2 * F5E_DEPTH, gated_adaln_bwd=F5E_DEPTH)
    seen = []

    class Recording(ftrainer.Trainer):
        def __post_init__(self):
            inner = self.log_fn

            def log_fn(metrics, update):
                counts = read_counts()
                seen.append(update)
                log(f"[training cli] update {update}: loss {metrics['loss']:.5f}, wall "
                    f"{metrics['step_seconds']:.3f} s, launches "
                    f"{ {k: v for k, v in counts.items() if v} }")
                check_counts(f"training cli update {update}", counts, expected)
                if not math.isfinite(metrics["loss"]):
                    raise AssertionError("the CLI's step is not finite")
                walls.append(metrics["step_seconds"])
                inner(metrics, update)

            self.log_fn = log_fn
            super().__post_init__()

        def make_step(self):
            step = super().make_step()
            if not profiled["on"]:
                return step

            def traced(*a, **kw):  # the resumed run's step, under torch.profiler
                out = {}
                profiled["busy"], profiled["kernels"], _ = device_busy(
                    "training cli step", lambda: out.setdefault("r", step(*a, **kw)))
                return out["r"]

            return traced

    walls: list = []
    profiled = {"on": False}
    args = ["--config", str(config), "--data_dir", str(tmp / "data"), "--device", "cuda"]
    original = ftrainer.Trainer
    ftrainer.Trainer = Recording
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        ts = cli.main(args + ["--max_updates", "2", "--no_resume"])
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(t.numel() for t in tree_leaves(ts.params))
        bytes8, bytes32 = state_bytes(ts.opt_state), 4 + 8 * n_params
        del ts
        profiled["on"] = True
        t0 = time.perf_counter()
        ts = cli.main(args + ["--max_updates", "3"])
        resume_s = time.perf_counter() - t0
    finally:
        ftrainer.Trainer = original
    log(f"[training cli] main(--max_updates 2): updates {seen[:2]} in {first_s:.1f} s (model "
        f"build, loader, two steps, model_last); step walls {[round(w, 3) for w in walls]}; "
        f"peak memory {peak / 2**30:.2f} GiB; 8-bit AdamW state {bytes8 / 2**20:.1f} MiB vs "
        f"{bytes32 / 2**20:.1f} MiB in fp32 ({bytes8 / bytes32:.3f}x) for {n_params / 1e6:.1f}M "
        f"params; resumed main(--max_updates 3): updates {seen[2:]} in {resume_s:.1f} s, its "
        f"step under torch.profiler: device busy {profiled['busy']:.1f} ms in "
        f"{profiled['kernels']} kernels (busy share {profiled['busy'] / (walls[1] * 1e3):.3f} "
        f"of update 2's wall)")
    if seen != [1, 2, 3] or ts.update != 3:
        raise AssertionError(f"the CLI ran updates {seen}, ending at {ts.update}")
    if not bytes8 < 0.3 * bytes32:
        raise AssertionError("the 8-bit AdamW state is not under 0.3x the fp32 state")
    del ts
    shutil.rmtree(tmp, ignore_errors=True)
    reset_counts()
    return expected



# ---------------------------------------------------------------------------
# the main entry point's options: sampler masks and the t_start probe,
# per-request seeds, int8 W8A8, engine directories, Whisper transcription
# ---------------------------------------------------------------------------

# bf16 with the kernels on the card against fp32 plain PyTorch on the CPU,
# relative L2 over the generated frames: the two round the same flow
# differently, ~1e-3 a step here
OPTIONS_REL = 2e-2
# a seeded request alone against the same seed in a batch of three: the
# noise is the same bits, but a GEMM of another M may take another cuBLAS
# algorithm, and 32 bf16 steps carry that rounding along
SEED_REL = 2e-2


def generated_rel(got: torch.Tensor, ref: torch.Tensor, rf: int) -> float:
    """Relative L2 of `got` against `ref` over the generated frames
    [rf, FIX_FRAMES) of the chunk."""
    g, r = got[..., rf:FIX_FRAMES, :].float(), ref[..., rf:FIX_FRAMES, :].float()
    return ((g - r).norm() / r.norm()).item()


def sampler_options_phase(sv: Serving) -> dict:
    """cfm.sample(use_mask=False) and the duplicate_test probe (t_start 0.5
    with a seeded test_cond: half the steps, the grid from t_start, the ODE
    from (1 - t) y0 + t test_cond) on the serving v1 model cut to 2 blocks
    at full width, on the card (bf16, kernels) against the CPU (fp32,
    plain), with the same y0: OPTIONS_REL over the generated frames; each
    run launches 2 x its steps of K1 and K2. The mask changes the output's
    bits."""
    from f5e_tts_tpu_torch.models import cfm as fcfm
    from f5e_tts_tpu_torch.train import step as fstep

    inputs, _ = sv.sampler_inputs()
    engine, rf = sv.engine, sv.ref_mel.shape[1]
    arch = dataclasses.replace(engine.arch, depth=2)
    params = {**engine.params, "blocks": engine.params["blocks"][:2]}
    params_cpu = fstep.tree_map(lambda t: t.float().cpu(), params)
    inputs_cpu = fcfm.SamplerInputs(*(None if t is None else t.cpu() for t in inputs))
    y0 = fcfm.noise_like(None, 1, 1536, 100, inputs.duration, seeds=[7])
    test_cond = torch.randn((1, 1536, 100), generator=torch.Generator(device="cuda").manual_seed(5),
                            device="cuda")
    cases = (("no mask", dict(use_mask=False, steps=4), 4),
             ("masked", dict(steps=4), 4),
             ("t_start probe", dict(t_start=0.5, test_cond=test_cond, steps=8), 4))
    outs, counts = {}, None
    for tag, kw, steps in cases:
        reset_counts()
        card, traj = fcfm.sample(params, arch, engine.cfm, inputs, cfg_strength=2.0,
                                 sway_coef=-1.0, y0=y0, compute_dtype=torch.bfloat16,
                                 device="cuda", **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(f"sampler options {tag}", counts,
                     expected_counts(rope_attention=2 * steps, gated_adaln=2 * steps))
        kw_cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()}
        cpu, _ = fcfm.sample(params_cpu, arch, engine.cfm, inputs_cpu, cfg_strength=2.0,
                             sway_coef=-1.0, y0=y0.cpu(), compute_dtype=torch.float32,
                             device="cpu", **kw_cpu)
        rel = generated_rel(card.cpu(), cpu, rf)
        log(f"[sampler options] {tag}: {traj.shape[0] - 1} steps, card (bf16) vs CPU (fp32) "
            f"relative L2 {rel:.3e} over the generated frames (tolerance {OPTIONS_REL})")
        if not (torch.isfinite(card).all() and rel <= OPTIONS_REL and traj.shape[0] == steps + 1):
            raise AssertionError(f"sampler options {tag}: card and CPU disagree")
        keep = inputs.cond_mask[:, :, None].expand_as(card)
        if not torch.equal(card[keep], inputs.cond[keep]):
            raise AssertionError(f"sampler options {tag}: the prompt frames are not the cond mel")
        outs[tag] = card
    moved = generated_rel(outs["no mask"], outs["masked"], rf)
    log(f"[sampler options] use_mask=False against the masked run: relative L2 {moved:.3e}")
    if torch.equal(outs["no mask"], outs["masked"]):
        raise AssertionError("use_mask=False left the output as the masked run's")
    return counts


def seeded_phase(sv: Serving) -> dict:
    """Per-request seeds on the card: noise_like(seeds=) of one seed alone,
    in slot 2 of a batch of three and as synthesize_chunk's batch-of-one
    draw, the same bits; the full-width v1 sampler (NFE 32, cfg 2) of the
    lone request gives synthesize_chunk(seed=)'s eager bits, and the batch's
    slot 2 agrees with it within SEED_REL; each run depth x NFE of K1, K2."""
    from f5e_tts_tpu_torch.models import cfm as fcfm

    inputs, kw = sv.sampler_inputs()
    engine, rf = sv.engine, sv.ref_mel.shape[1]
    three = fcfm.SamplerInputs(*(None if t is None else t.repeat(3, *[1] * (t.dim() - 1))
                                 for t in inputs))
    alone = fcfm.noise_like(None, 1, 1536, 100, inputs.duration, seeds=[7])
    drawn = fcfm.noise_like(torch.Generator(device="cuda").manual_seed(7), 1, 1536, 100,
                            inputs.duration)
    batch = fcfm.noise_like(None, 3, 1536, 100, three.duration,
                            seeds=torch.tensor([11, 23, 7], device="cuda"))
    if not (torch.equal(batch[2:], alone) and torch.equal(alone, drawn)):
        raise AssertionError("seeded noise differs alone, in a batch and as the pipeline draws it")
    log("[seeded requests] seed 7's noise alone, in slot 2 of a batch of three and as "
        "synthesize_chunk's draw: the same bits")
    run = dict(steps=NFE, cfg_strength=2.0, sway_coef=-1.0, compute_dtype=torch.bfloat16,
               device="cuda", timesteps=kw.get("timesteps"))
    want = expected_counts(rope_attention=DEPTH * NFE, gated_adaln=DEPTH * NFE)
    lone = fcfm.sample(engine.params, engine.arch, engine.cfm, inputs, seeds=[7], **run)[0]
    check_counts("seeded request alone", read_counts(), want)
    eager = sv.sampler_out(eager=True)
    check_counts("seeded request, the pipeline", read_counts(), want)
    if not torch.equal(lone, eager):
        raise AssertionError("sample(seeds=[7]) differs from synthesize_chunk(seed=7)")
    out3 = fcfm.sample(engine.params, engine.arch, engine.cfm, three, seeds=[11, 23, 7], **run)[0]
    counts = read_counts()
    check_counts("seeded batch of three", counts, want)
    rel = generated_rel(out3[2:], lone, rf)
    log(f"[seeded requests] sample(seeds=[7]) gives synthesize_chunk(seed=7)'s bits; slot 2 of "
        f"the batch of three against it: relative L2 {rel:.3e} (tolerance {SEED_REL}), bitwise "
        f"{torch.equal(out3[2:], lone)}; slots 0 and 1 differ from it: "
        f"{generated_rel(out3[:1], lone, rf):.3e}, {generated_rel(out3[1:2], lone, rf):.3e}")
    if not (torch.isfinite(out3).all() and rel <= SEED_REL):
        raise AssertionError("the seeded request's mel in a batch differs from its mel alone")
    # the device busy of a batch against one request: batched_serving_phase (a batch of 4)
    reset_counts()
    return counts


def int8_pass_share(q_blk: dict, b_blk: dict, busy_ms: float) -> dict:
    """Per-token quantization passes of the int8 sampler: for each of a
    block's four quantized linears at the sampler's M = 2 x 1536 rows, one
    int8_linear call against its torch._int_mm alone and the bf16 linear
    (CUDA events, one input set: each operand stays in L2, as in the
    sampler); the passes' time is their difference, times depth x NFE calls,
    and their share of the int8 sampler's device busy."""
    from f5e_tts_tpu_torch.ops import nn as fnn
    from f5e_tts_tpu_torch.ops import quant as fq

    gen = torch.Generator(device="cuda").manual_seed(8)
    out, passes = {}, 0.0
    for name, q, b in (("to_qkv", q_blk["attn"]["to_qkv"], b_blk["attn"]["to_qkv"]),
                       ("to_out", q_blk["attn"]["to_out"], b_blk["attn"]["to_out"]),
                       ("ff1", q_blk["ff1"], b_blk["ff1"]), ("ff2", q_blk["ff2"], b_blk["ff2"])):
        x = torch.randn((2 * 1536, q["w_q"].shape[0]), generator=gen, device="cuda").bfloat16()
        x_q, _ = fq._symmetric_int8(x.float(), -1)
        total = cuda_ms([lambda: fq.int8_linear(q, x, torch.bfloat16)])
        mm = cuda_ms([lambda: torch._int_mm(x_q, q["w_q"])])
        bf = cuda_ms([lambda: fnn.linear(b, x, torch.bfloat16)])
        passes += (total - mm) * DEPTH * NFE
        out[name] = {"int8_linear_ms": total, "int_mm_ms": mm, "bf16_linear_ms": bf}
        log(f"[int8 synthesis] {name} ({x.shape[0]} x {x.shape[1]} -> {q['w_q'].shape[1]}): "
            f"int8_linear {total:.4f} ms = _int_mm {mm:.4f} ms + passes {total - mm:.4f} ms; "
            f"bf16 linear {bf:.4f} ms")
    out["passes_ms_per_sampler"] = passes
    out["passes_share_of_busy"] = passes / busy_ms
    log(f"[int8 synthesis] the quantization passes: {passes:.1f} ms a sampler run "
        f"({DEPTH} x {NFE} calls of each linear), {passes / busy_ms:.3f} of its device busy")
    return out


def int8_phase(sv: Serving) -> dict:
    """F5TTS("F5TTS_v1_Base", quantize="int8"), the serving model's weights
    with the trunk's four matmuls a block in W8A8 (torch._int_mm): eager
    synthesis as the synthesis phase checks it (depth x NFE of K1 and K2),
    the generated mel's relative L2 against the bf16 model's from the same
    noise, the sampler's device busy beside bf16's (the captured phase's,
    this run) and the quantization passes' share; then its bucket-1536
    engine captured (depth x (NFE + 1) at capture), the replay gives the
    eager bits, replay busy beside bf16's, three timed captured syntheses."""
    from f5e_tts_tpu_torch.utils.aot import capture_sampler_buckets

    tts = preset_tts("int8 synthesis", "F5TTS_v1_Base", quantize="int8")
    engine = tts.engine
    blk, bblk = engine.params["blocks"][0], sv.engine.params["blocks"][0]
    for p in (blk["attn"]["to_qkv"], blk["attn"]["to_out"], blk["ff1"], blk["ff2"]):
        if p["w_q"].dtype != torch.int8 or p["w_q"].stride(0) != 1:
            raise AssertionError("the int8 model's trunk is not in column-major int8")
    if not (torch.equal(engine.params["proj_out"]["w"], sv.engine.params["proj_out"]["w"])
            and torch.equal(blk["attn_norm"]["w"], bblk["attn_norm"]["w"])):
        raise AssertionError("the int8 model's float weights differ from the bf16 model's")
    want = expected_counts(rope_attention=DEPTH * NFE, gated_adaln=DEPTH * NFE)
    ref = str(reference_wav())

    def infer():
        return tts.infer(ref, REF_TEXT, GEN_TEXT, nfe_step=NFE, cfg_strength=2.0,
                         sway_sampling_coef=-1.0, fix_duration=FIX_DURATION, seed=7)

    # one timed run and no profile of the synthesis (~25 s of the run's time):
    # the eager sampler's busy below gives the device time
    counts = synthesis_phase("int8 synthesis", infer, want, runs=1, profile=False)
    rf = sv.ref_mel.shape[1]
    q_out = sv.sampler_out(eager=True, engine=engine)
    b_out = sv.sampler_out(eager=True)
    reset_counts()
    rel = generated_rel(q_out, b_out, rf)
    log(f"[int8 synthesis] sampler output against the bf16 model's from the same noise: relative "
        f"L2 {rel:.3e} over the generated frames, max|diff| "
        f"{(q_out - b_out)[0, rf:FIX_FRAMES].abs().max().item():.3e} of max|bf16| "
        f"{b_out[0, rf:FIX_FRAMES].abs().max().item():.3e}")
    if not (torch.isfinite(q_out).all() and torch.equal(q_out[0, :rf], b_out[0, :rf])):
        raise AssertionError("int8 synthesis: a non-finite output or changed prompt frames")
    busy_q = device_busy("int8 eager sampler", lambda: sv.sampler_out(eager=True, engine=engine))[0]
    busy_b, busy_br = sv.sampler_busy[NFE]  # the bf16 model's, eager and replayed (captured phase)
    log(f"[int8 synthesis] eager sampler device busy: int8 {busy_q:.1f} ms, bf16 {busy_b:.1f} ms "
        f"({busy_q / busy_b:.3f}x)")
    int8_pass_share(blk, bblk, busy_q)

    reset_counts()
    t0 = time.perf_counter()
    names = capture_sampler_buckets(engine, buckets=(1536,), nfe=NFE)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    check_counts("int8 capture", read_counts(),
                 expected_counts(rope_attention=DEPTH * (NFE + 1), gated_adaln=DEPTH * (NFE + 1)))
    replayed = sv.sampler_out(engine=engine)
    check_counts("int8 replay", read_counts(), expected_counts())
    if not torch.equal(replayed, q_out):
        diff = (replayed.float() - q_out.float()).abs().max().item()
        raise AssertionError(f"int8: the replay differs from the eager sampler (max {diff})")
    log(f"[int8 synthesis] captured {names} in {capture_s:.2f} s; the replay gives the eager bits")
    busy_qr = device_busy("int8 replayed sampler", lambda: sv.sampler_out(engine=engine))[0]
    log(f"[int8 synthesis] replayed sampler device busy: int8 {busy_qr:.1f} ms, bf16 "
        f"{busy_br:.1f} ms ({busy_qr / busy_br:.3f}x)")
    walls = []
    for run in ["warm-up"] + [f"timed {i + 1}" for i in range(3)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav, sr, _ = infer()
        torch.cuda.synchronize()
        check_counts(f"int8 captured synthesis {run}", read_counts(), expected_counts())
        if run != "warm-up":
            walls.append(time.perf_counter() - t0)
    if not (np.isfinite(wav).all() and np.sqrt(np.mean(np.square(wav))) > 0):
        raise AssertionError("int8 captured synthesis: non-finite or silent wav")
    wall = float(np.median(walls))
    log(f"[int8 synthesis] captured synthesis: wall {wall:.3f} s (median of 3), RTF "
        f"{wall / (len(wav) / sr):.5f}")
    reset_counts()
    return counts


class StandInASR:
    """A stand-in for the transformers Whisper pipeline: records its calls
    and answers with the reference's transcript."""

    def __init__(self):
        self.calls, self.devices = [], []

    def __call__(self, audio, **kwargs):
        self.calls.append(kwargs)
        return {"text": f"  {REF_TEXT} "}


def engine_dir_asr_phase(sv: Serving) -> dict:
    """F5TTS("F5TTS_v1_Base", engine_dir=, asr_model=) over a directory of
    empty files named as the JAX exporter names engines (bucket 1536 at NFE
    32 for two prompt and text lengths, bucket 1024, the EPSS grid at 1536)
    and a stand-in Whisper pipeline: the captured engines are exactly those
    named (depth x the steps + 1 of each at capture) and a replay gives the
    eager bits; an empty ref_text is transcribed once, cached for the next
    request, and the synthesis equals the one with the transcript given."""
    from f5e_tts_tpu_torch.infer import transcribe as ftranscribe
    from f5e_tts_tpu_torch.utils import aot

    tmp = ROOT / "build" / "smoke" / "engines"
    shutil.rmtree(tmp, ignore_errors=True)
    (tmp / "whisper").mkdir(parents=True)
    tag = aot.variant_tag(sv.grid)
    for name in (f"sampler_nfe{NFE}_ref472_b1536_t256", f"sampler_nfe{NFE}_ref100_b1536_t512",
                 f"sampler_nfe{NFE}_ref472_b1024_t256", f"sampler_nfe{EPSS_NFE}{tag}_ref472_b1536_t256",
                 "ppg_b1_t400"):
        (tmp / f"{name}.jaxexport").touch()
    want = {aot.engine_name(NFE, 1536), aot.engine_name(NFE, 1024),
            aot.engine_name(EPSS_NFE, 1536, sv.grid)}
    asr = StandInASR()
    init = ftranscribe.initialize_asr_pipeline

    def stand_in(model_dir=None, device="cuda"):
        asr.devices.append(str(device))
        return asr

    ftranscribe.initialize_asr_pipeline = stand_in
    try:
        reset_counts()
        t0 = time.perf_counter()
        tts = preset_tts("engine dir", "F5TTS_v1_Base", engine_dir=str(tmp),
                         asr_model=str(tmp / "whisper"))
        log(f"[engine dir] F5TTS(engine_dir=, asr_model=) built and captured in "
            f"{time.perf_counter() - t0:.1f} s: {sorted(tts.engine.engines)}")
        steps = 2 * (NFE + 1) + EPSS_NFE + 1
        check_counts("engine dir capture", read_counts(),
                     expected_counts(rope_attention=DEPTH * steps, gated_adaln=DEPTH * steps))
        if set(tts.engine.engines) != want:
            raise AssertionError(f"captured {sorted(tts.engine.engines)}, named {sorted(want)}")
        for timesteps in (None, sv.grid):
            replayed = sv.sampler_out(timesteps, engine=tts.engine)
            check_counts("engine dir replay", read_counts(), expected_counts())
            eager = sv.sampler_out(timesteps, eager=True, engine=tts.engine)
            reset_counts()
            if not torch.equal(replayed, eager):
                raise AssertionError("engine dir: a replay differs from the eager sampler")
        log("[engine dir] the captured buckets are those named; replays (NFE 32, EPSS) give the "
            "eager bits")
        ref = str(reference_wav())
        outs = []
        for ref_text in ("", "", REF_TEXT):
            outs.append(tts.infer(ref, ref_text, GEN_TEXT, nfe_step=NFE, cfg_strength=2.0,
                                  sway_sampling_coef=-1.0, fix_duration=FIX_DURATION, seed=7))
            check_counts("asr synthesis (replayed)", read_counts(), expected_counts())
        log(f"[asr model] an empty ref_text twice, then the transcript: the stand-in pipeline ran "
            f"{len(asr.calls)} time(s) on {asr.devices}, {asr.calls[:1]}")
        if len(asr.calls) != 1 or asr.devices != ["cuda"]:
            raise AssertionError("the empty ref_text was not transcribed once on the card")
        if not all(np.array_equal(o[0], outs[2][0]) for o in outs[:2]):
            raise AssertionError("the transcribed request's wav differs from the given text's")
        wav = outs[0][0]
        if not (np.isfinite(wav).all() and np.sqrt(np.mean(np.square(wav))) > 0):
            raise AssertionError("asr synthesis: non-finite or silent wav")
        log("[asr model] the transcribed request gives the wav of the request with its text")
    finally:
        ftranscribe.initialize_asr_pipeline = init
    return expected_counts()


# the serving phase's four requests: (reference seconds, text, fix_duration,
# seed). Every total lands in bucket 1536 (1312, 1359, 1416, 1453 frames), so
# the four fold into one (4, 1536) batch, the folded rows' key lengths these
# durations twice over
SERVE_REQUESTS = (
    (4.02, "The river bends twice before it reaches the old mill by the bridge.", 14.0, 11),
    (4.51, "A light rain kept falling on the roofs of the quiet town all evening.", 14.5, 23),
    (5.03, GEN_TEXT, FIX_DURATION, 7),
    (5.52, "She read the letter slowly, then folded it and put it in her coat.", 15.5, 31))
SERVE_FRAMES = tuple(int(fix * 24_000 / 256) for _, _, fix, _ in SERVE_REQUESTS)
# a request alone against the same request in a batch of four: the same noise
# bits, but GEMMs of another M may take other cuBLAS algorithms
SERVE_REL = 1e-2
# texts of the server requests: with the 5.03 s reference and no fix_duration
# the duration estimate puts each in bucket 1536 (checked)
SERVER_TEXTS = (
    "Early in the morning the fishermen pushed their boats out past the rocks into the calm grey sea.",
    "The old clock in the hall struck nine, and somewhere upstairs a door closed softly behind someone.",
    "We walked along the shore until the lights of the harbour disappeared behind the hill at dusk.",
    "Nobody knew where the path through the forest ended, so we followed it until the trees thinned.")


def batched_serving_phase(sv: Serving) -> dict:
    """The serving batcher on the v1 model at bucket 1536, NFE 32, cfg 2:
    four concurrent requests (SERVE_REQUESTS) through TTSEngine.infer fold
    into one batch of 4, eager (depth x NFE of K1 and K2) and replayed from
    the (4, 1536) engine that warm_up_buckets captures with (1, 1536) and
    (2, 1536) (3 x depth x (NFE + 1) at capture, 0 a replay); each request's
    mel against the same request alone within SERVE_REL (bitwise printed),
    the replayed batch against the eager one bit for bit; the int16 wire,
    xfer_chunks and return_mel=False against the float32 wire; the HTTP,
    socket (f32, pcm16) and gRPC (streaming, offline) servers on free ports;
    load numbers (concurrency 4 against four sequential requests, eager and
    captured, an open-loop run) and the sampler busy of a batch of 4 against
    one request. Returns {path: launch counts} of the eager batch and of the
    capture."""
    import io
    import socket
    import threading
    import urllib.request

    from f5e_tts_tpu_torch.infer.pipeline import pick_bucket
    from f5e_tts_tpu_torch.models import cfm as fcfm
    from f5e_tts_tpu_torch.serving import benchmark as fbench
    from f5e_tts_tpu_torch.serving import grpc_client, grpc_server, socket_client, socket_server
    from f5e_tts_tpu_torch.serving import tts_pb2
    from f5e_tts_tpu_torch.serving.batcher import DynamicBatcher
    from f5e_tts_tpu_torch.serving import http_server as fhttp

    eng = dataclasses.replace(sv.engine, engines={}, graph_pool=None,
                              graph_lock=threading.Lock(), batcher=None, _ref_mel_cache={})
    wavs = [speech_like(sec, seed=i + 1).astype(np.float32)
            for i, (sec, _, _, _) in enumerate(SERVE_REQUESTS)]
    want = expected_counts(rope_attention=DEPTH * NFE, gated_adaln=DEPTH * NFE)
    out: dict = {}

    def one(i):
        _, text, fix, seed = SERVE_REQUESTS[i]
        return eng.infer(wavs[i], 24_000, REF_TEXT, text, seed=seed, fix_duration=fix,
                         nfe_steps=NFE, cfg_strength=2.0, sway=-1.0)

    def alone(i):
        """The request on the direct path (no batcher)."""
        bt, eng.batcher = eng.batcher, None
        try:
            return one(i)
        finally:
            eng.batcher = bt

    def concurrent(fn, n=4):
        """fn(i) for i < n from n threads released together, each in
        inference mode; the results in order, and the wall."""
        results, errors, barrier = [None] * n, [], threading.Barrier(n)

        def run(i):
            try:
                with torch.inference_mode():
                    barrier.wait()
                    results[i] = fn(i)
            except Exception as e:  # noqa: BLE001 -- re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"concurrent requests failed: {errors}")
        return results, wall

    def check_batch(tag, got, ref, counts_want):
        counts = read_counts()
        check_counts(tag, counts, counts_want)
        if eng.batcher.batch_sizes != [4]:
            raise AssertionError(f"{tag}: batches {eng.batcher.batch_sizes}, expected [4]")
        rels, bitwise = [], []
        for (wav, _, mel), (_, _, mel_a) in zip(got, ref):
            if not (np.isfinite(wav).all() and np.sqrt(np.mean(np.square(wav))) > 0):
                raise AssertionError(f"{tag}: non-finite or silent wav")
            rels.append(float(np.linalg.norm(mel - mel_a) / np.linalg.norm(mel_a)))
            bitwise.append(bool(np.array_equal(mel, mel_a)))
        log(f"[batched serving] {tag}: one batch of 4, launches "
            f"{ {k: v for k, v in counts.items() if v} }; each request's mel against the same "
            f"request alone: relative L2 {[f'{r:.3e}' for r in rels]} (tolerance {SERVE_REL}), "
            f"bitwise {bitwise}")
        if max(rels) > SERVE_REL:
            raise AssertionError(f"{tag}: a request's mel in the batch differs from its mel alone")
        eng.batcher.batch_sizes.clear()
        eng.batcher.stage_times.clear()
        return counts

    # the four requests alone, eager (depth x NFE each), then co-batched eager
    reset_counts()
    eager_alone = []
    for i in range(4):
        eager_alone.append(alone(i))
        check_counts(f"request {i} alone, eager", read_counts(), want)
    eng.enable_batching(max_batch=4, window_ms=100.0, nfe_steps=NFE)
    try:
        got, wall_eager = concurrent(one)
        out["batched_synthesis"] = check_batch("eager batch", got, eager_alone, want)
        eager_batch = got

        # capture: warm_up_buckets through the batcher captures (b, 1536) for
        # b = 1, 2, 4; each capture timed, its launches and the memory it
        # reserved read on its own (the capture empties the allocator's cache
        # as it starts, so the readings follow an empty_cache too)
        per_capture, capture = [], expected_counts()
        capture_fn = fhttp.capture_sampler_buckets

        def each_capture(engine, buckets, batches=(1,), **kw):
            names = []
            for b in batches:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reserved, t0 = torch.cuda.memory_reserved(), time.perf_counter()
                names += capture_fn(engine, buckets, batches=(b,), **kw)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                torch.cuda.empty_cache()
                counts = read_counts()
                check_counts(f"capture of (b={b}, 1536)", counts, expected_counts(
                    rope_attention=DEPTH * (NFE + 1), gated_adaln=DEPTH * (NFE + 1)))
                for k, v in counts.items():
                    capture[k] += v
                per_capture.append((b, seconds, (torch.cuda.memory_reserved() - reserved) / 2**20))
            return names

        ref_mel = eng._reference(wavs[2], 24_000)[2]
        fhttp.capture_sampler_buckets = each_capture
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            names = fhttp.warm_up_buckets(eng, ref_mel, REF_TEXT, NFE, buckets=(1536,))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            fhttp.capture_sampler_buckets = capture_fn
        check_counts("batched serving warm-up batches", read_counts(), expected_counts())
        for b, sec, mib in per_capture:
            log(f"[batched serving] capture of (b={b}, 1536): {sec:.2f} s, {mib:.1f} MiB more "
                f"reserved, {DEPTH * (NFE + 1)} launches of K1 and of K2 counted")
        log(f"[batched serving] warm_up_buckets captured {names} and ran batches "
            f"{eng.batcher.batch_sizes} through the batcher in {seconds:.2f} s; launches at "
            f"capture { {k: v for k, v in capture.items() if v} }, 0 in the replays")
        if names != [f"sampler_nfe{NFE}_b1536", f"sampler_nfe{NFE}_b1536_x2",
                     f"sampler_nfe{NFE}_b1536_x4"] or eng.batcher.batch_sizes != [1, 2, 4]:
            raise AssertionError(f"warm-up captured {names}, ran {eng.batcher.batch_sizes}")
        out["batched_serving_capture"] = capture
        eng.batcher.batch_sizes.clear()
        eng.batcher.stage_times.clear()

        # replayed: alone (the (1, 1536) engine, the eager bits), then the batch of 4
        replayed_alone = []
        for i in range(4):
            replayed_alone.append(alone(i))
            check_counts(f"request {i} alone, replayed", read_counts(), expected_counts())
            if not np.array_equal(replayed_alone[i][2], eager_alone[i][2]):
                raise AssertionError(f"request {i}: the (1, 1536) replay differs from eager")
        got, wall_replayed = concurrent(one)
        check_batch("replayed batch", got, replayed_alone, expected_counts())
        same = [bool(np.array_equal(g[2], e[2])) for g, e in zip(got, eager_batch)]
        log(f"[batched serving] the (4, 1536) replay against the eager batch of 4: bitwise {same}")
        if not all(same):
            raise AssertionError("the (4, 1536) replay differs from the eager batch of 4")
        log(f"[batched serving] four concurrent requests: wall {wall_eager:.3f} s eager, "
            f"{wall_replayed:.3f} s replayed")

        # the wire variants against the float32 wire, the same four requests
        reqs = []
        for i, (_, text, fix, seed) in enumerate(SERVE_REQUESTS):
            ids = eng.tokenize([REF_TEXT + " " + text])[0]
            reqs.append((eng._reference(wavs[i], 24_000)[2][0], ids[ids >= 0],
                         int(fix * 24_000 / 256), seed))

        def submit_all(batcher):
            futs = [batcher.submit(*r[:3], seed=r[3]) for r in reqs]
            return [f.result(timeout=600) for f in futs]

        base = submit_all(eng.batcher)
        for (_, mel), (_, _, mel_a) in zip(base, got):
            if not np.array_equal(mel, mel_a):
                raise AssertionError("a submitted request differs from the same request via infer")
        variants = {}
        for tag, kw in (("int16 wire", dict(wire_dtype="int16")),
                        ("xfer_chunks=2", dict(return_mel=False, xfer_chunks=2)),
                        ("return_mel=False", dict(return_mel=False))):
            bt = DynamicBatcher(eng, max_batch=4, window_ms=100.0, nfe_steps=NFE,
                                text_pad_to=eng.text_pad_to, **kw)
            try:
                variants[tag] = submit_all(bt)
                if bt.batch_sizes != [4]:
                    raise AssertionError(f"{tag}: batches {bt.batch_sizes}")
            finally:
                bt.stop()
        i16_err = max(float(np.abs(q - np.clip(w, -1, 1)).max())
                      for (w, _), (q, _) in zip(base, variants["int16 wire"]))
        if i16_err > 1 / 32767 + np.spacing(np.float32(1.0)):
            raise AssertionError(f"int16 wire: max |int16 - float32| {i16_err}")
        for tag in ("xfer_chunks=2", "return_mel=False"):
            for (w, _), (v, m) in zip(base, variants[tag]):
                if m is not None or not np.array_equal(v, w):
                    raise AssertionError(f"{tag}: not the float32 wire's (wav, None)")
        log(f"[batched serving] int16 wire within {i16_err:.3e} of the float32 wav (1/32767 + 1 "
            f"ulp allowed); xfer_chunks=2 and return_mel=False give its wavs, mel None")
        eng.batcher.batch_sizes.clear()
        eng.batcher.stage_times.clear()

        # the servers, each on a free port of 127.0.0.1
        sr, hop = 24_000, 256
        ref_len = len(wavs[2]) // hop
        for text in SERVER_TEXTS:
            total = ref_len + int(ref_len / len((REF_TEXT + " ").encode()) * len(text.encode()))
            if pick_bucket(total) != 1536:
                raise AssertionError(f"server text of {total} frames, not in bucket 1536")

        def audible(wav, tag):
            rms = float(np.sqrt(np.mean(np.square(wav)))) if len(wav) else 0.0
            if not (len(wav) and np.isfinite(wav).all() and rms > 0):
                raise AssertionError(f"{tag}: empty, non-finite or silent wav")
            log(f"[batched serving] {tag}: {len(wav) / sr:.3f} s of audio, rms {rms:.4f}")

        http = fhttp.make_server(eng, wavs[2], sr, REF_TEXT, host="127.0.0.1", port=0,
                                 nfe=NFE, warm=False)
        threading.Thread(target=http.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{http.server_address[1]}"

        def post(i):
            body = json.dumps({"text": SERVER_TEXTS[i], "seed": i}).encode()
            req = urllib.request.Request(url + "/tts", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                data = r.read()
            with wave.open(io.BytesIO(data)) as f:
                return np.frombuffer(f.readframes(f.getnframes()), np.int16) / 32767.0

        try:
            audible(post(0), "HTTP one request")
            posted, wall = concurrent(post)
            for i, wav in enumerate(posted):
                audible(wav, f"HTTP concurrent request {i}")
            log(f"[batched serving] four concurrent HTTP requests: batches "
                f"{eng.batcher.batch_sizes} in {wall:.3f} s")
            if eng.batcher.batch_sizes != [1, 4]:
                raise AssertionError(f"HTTP: batches {eng.batcher.batch_sizes}, expected [1, 4]")
        finally:
            http.shutdown()
            http.server_close()
        for wire in ("f32", "pcm16"):
            proc = socket_server.TTSStreamingProcessor(eng, wavs[2], sr, REF_TEXT, nfe_steps=NFE,
                                                       warm_up=False, wire=wire)
            lsock = socket_server.listen("127.0.0.1", 0)
            threading.Thread(target=socket_server.serve, args=(proc,), kwargs=dict(srv=lsock),
                             daemon=True).start()
            try:
                wav, first = socket_client.request("127.0.0.1", lsock.getsockname()[1],
                                                   SERVER_TEXTS[1], timeout=600, wire=wire)
            finally:
                lsock.shutdown(socket.SHUT_RDWR)
            audible(wav, f"socket ({wire}), first chunk after {first:.3f} s")
        proc = socket_server.TTSStreamingProcessor(eng, wavs[2], sr, REF_TEXT, nfe_steps=NFE,
                                                   warm_up=False)
        server, port = grpc_server.make_server(proc, host="127.0.0.1", port=0)
        server.start()
        try:
            import grpc

            with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
                stream_stub, offline_stub = grpc_client._stubs(channel)
                req = tts_pb2.TTSRequest(gen_text=SERVER_TEXTS[2], nfe_steps=NFE)
                streamed = grpc_client.run_once(stream_stub, offline_stub, req)
                offline = grpc_client.run_once(stream_stub, offline_stub, req, offline=True)
        finally:
            server.stop(grace=None)
        audible(streamed["wav"], f"gRPC streaming, first chunk after {streamed['first_chunk_s']:.3f} s")
        audible(offline["wav"], "gRPC offline")
        if not np.array_equal(streamed["wav"], offline["wav"]):
            raise AssertionError("gRPC: the streamed wav differs from the offline one")
        reset_counts()
        eng.batcher.batch_sizes.clear()
        eng.batcher.stage_times.clear()

        # load numbers (no gate), at the batcher's default 20 ms window:
        # concurrency 4 against four sequential requests (through the batcher,
        # which waits out the window for each, and on the direct path), eager
        # and captured; the busy share of one batch of 4; one open-loop run
        eng.batcher.window_s = 0.020
        texts = list(SERVER_TEXTS)
        engines = eng.engines

        def load(tag, conc):
            st = fbench.bench_concurrent(eng, wavs[2], sr, REF_TEXT, texts, nfe=NFE,
                                         concurrency=conc, warmup=False)
            log(f"[batched serving] load, {tag}: {st['n'] / st['wall_s']:.3f} requests/s, "
                f"wall {st['wall_s']:.3f} s, RTF {st['rtf']:.5f}, p50 {st['p50_ms']:.1f} ms, p95 "
                f"{st['p95_ms']:.1f} ms, batches {st['batch_sizes']}, stages "
                f"{st.get('stage_totals')}")
            return st["n"] / st["wall_s"]

        for mode in ("eager", "captured"):
            eng.engines = {} if mode == "eager" else engines
            rate4 = load(f"{mode}, concurrency 4", 4)
            rate1 = load(f"{mode}, four sequential requests through the batcher", 1)
            bt, eng.batcher = eng.batcher, None
            try:
                direct = load(f"{mode}, four sequential requests on the direct path", 1)
            finally:
                eng.batcher = bt
            log(f"[batched serving] load, {mode}: concurrency 4 gives {rate4 / rate1:.3f}x the "
                f"requests/s of four sequential requests through the batcher, "
                f"{rate4 / direct:.3f}x those on the direct path")
            eng.batcher.batch_sizes.clear()
            _, wall = concurrent(lambda i: eng.infer(wavs[2], sr, REF_TEXT, texts[i], seed=i,
                                                     nfe_steps=NFE))
            log(f"[batched serving] one {mode} batch of 4: wall {wall:.3f} s, batches "
                f"{eng.batcher.batch_sizes}")
            eng.batcher.batch_sizes.clear()
            if mode == "captured":  # one profiled batch: its busy share of that wall
                profile_run(f"batched serving, one {mode} batch of 4",
                            lambda: concurrent(lambda i: eng.infer(wavs[2], sr, REF_TEXT,
                                                                   texts[i], seed=i,
                                                                   nfe_steps=NFE)), wall)
                eng.batcher.batch_sizes.clear()
        eng.engines = engines
        st = fbench.bench_openloop(eng, wavs[2], sr, REF_TEXT, texts * 2, nfe=NFE, qps=3.0, seed=0,
                                   warmup=False)
        log(f"[batched serving] load, captured, open loop at 3.0 requests/s offered: "
            f"{st['qps_achieved']:.3f} achieved, p50 {st['p50_ms']:.1f} ms, p95 {st['p95_ms']:.1f} "
            f"ms, batches {st['batch_sizes']}, mean batch {st['mean_batch']:.2f}, stages "
            f"{st.get('stage_totals')}")
        reset_counts()

        # the sampler's device busy: a batch of 4 against one request
        inputs, _ = sv.sampler_inputs()
        four = fcfm.SamplerInputs(*(None if t is None else t.repeat(4, *[1] * (t.dim() - 1))
                                    for t in inputs))
        run = dict(steps=NFE, cfg_strength=2.0, sway_coef=-1.0, compute_dtype=torch.bfloat16,
                   device="cuda")
        busy4 = device_busy("batched serving, eager sampler of 4", lambda: fcfm.sample(
            eng.params, eng.arch, eng.cfm, four, seeds=[11, 23, 7, 31], **run))[0]
        busy1 = sv.sampler_busy[NFE][0]  # the same request's eager sampler (captured phase)
        r4 = device_busy("batched serving, (4, 1536) replay", eng.engines[names[2]].graph.replay)[0]
        r1 = device_busy("batched serving, (1, 1536) replay", eng.engines[names[0]].graph.replay)[0]
        log(f"[batched serving] sampler device busy, batch of 4 against one request: eager "
            f"{busy4:.1f} / {busy1:.1f} ms ({busy4 / busy1:.3f}x), replayed {r4:.1f} / {r1:.1f} ms "
            f"({r4 / r1:.3f}x)")
        reset_counts()
        return out
    finally:
        eng.batcher.stop()


def k2_sass_check(lib: Path) -> None:
    """Every gated_adaln_kernel instantiation of the built K2/K5 library
    moves its rows in 128-bit global loads and stores and none in 16-bit
    ones (cuobjdump -sass, beside nvcc)."""
    from f5e_tts_tpu_torch.kernels import _build

    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    seen = []
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        found = re.search(r"gated_adaln_kernelILi(\d+)E", fn)
        if not found:
            continue
        ops = {op: len(re.findall(pat, body)) for op, pat in (
            ("LDG.E.128", r"\bLDG\.E\.128\b"), ("STG.E.128", r"\bSTG\.E\.128\b"),
            ("LDG.E.U16", r"\bLDG\.E\.U16\b"), ("16-bit global", r"\b[LS]TG\.E\.[US]?16\b"),
            ("BAR.SYNC", r"\bBAR\.SYNC\b"), ("SHFL", r"\bSHFL\."))}
        log(f"[build] gated_adaln_kernel V={found.group(1)} SASS: {ops}")
        if ops["LDG.E.128"] == 0 or ops["STG.E.128"] == 0 or ops["16-bit global"]:
            raise AssertionError(f"gated_adaln_kernel V={found.group(1)}: not 128-bit only {ops}")
        seen.append(int(found.group(1)))
    if sorted(seen) != [1, 2, 3, 4, 8, 16]:
        raise AssertionError(f"gated_adaln_kernel instantiations {sorted(seen)} in the SASS")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from f5e_tts_tpu_torch.config import MMDiTConfig, ModelConfig, preset
    from f5e_tts_tpu_torch.kernels import _build
    from f5e_tts_tpu_torch.kernels import attention as ka
    from f5e_tts_tpu_torch.kernels import gated_adaln as ga
    from f5e_tts_tpu_torch.kernels import rope_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    libs = _build.build()
    log(f"[build] {len(libs)} kernel libraries built in {time.perf_counter() - t_start:.1f} s")
    build_report(libs, ra)
    k2_sass_check(libs["gated_adaln"])
    register_counters(ra, ga, ka)
    swaps = plain_swaps(ra, ga, ka)
    byte_model = lambda cfg: dataclasses.replace(cfg, tokenizer="byte", vocab_size=256)  # noqa: E731
    runs: dict = {}  # path -> {counter: launches in one run of it}

    def phase(name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.empty_cache()
        log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_start:.0f} s since the start)")
        return result

    # K1's, K4's and K5's device time by kernel, for their rows (launches here count on no path)
    splits = phase("kernel splits", lambda: split_phase((ra, ka), ga))
    reset_counts()

    # F5TTS_v1_Base: K1/K2 in synthesis, K1/K2/K4/K5 in training
    with torch.inference_mode():
        runs["synthesis"] = phase("synthesis", lambda: preset_synthesis_phase(
            "synthesis", preset_tts("synthesis", "F5TTS_v1_Base"),
            expected_counts(rope_attention=DEPTH * NFE, gated_adaln=DEPTH * NFE), runs=3))
    v1 = byte_model(preset("F5TTS_v1_Base"))
    assert (v1.arch.depth, v1.arch.dropout) == (DEPTH, 0.1), v1.arch
    runs["training_step"], _ = phase("training", lambda: training_phase(
        "training", v1, expected_counts(rope_attention=DEPTH, rope_attention_bwd=DEPTH,
                                        gated_adaln=DEPTH, gated_adaln_bwd=DEPTH),
        updates=4, warmup=1, resume=True))
    phase("gradients", lambda: gradient_phase(swaps))

    # MMDiT: K7 in synthesis, K9/K10 in training, K7/K8 through a masked loss
    with torch.inference_mode():
        runs["mmdit_synthesis"] = phase("mmdit synthesis", lambda: mmdit_synthesis_phase(
            expected_counts(joint_attention=MMDIT_DEPTH * NFE)))
    mmdit = ModelConfig(name="MMDiT", backbone="MMDiT", tokenizer="byte", vocab_size=256,
                        arch=MMDiTConfig())
    runs["mmdit_training_step"], text_len = phase("mmdit training", lambda: training_phase(
        "mmdit training", mmdit, expected_counts(masked_attention=MMDIT_DEPTH,
                                                 masked_attention_bwd=MMDIT_DEPTH),
        updates=4, warmup=2))
    runs["mmdit_masked_gradient"] = phase("mmdit gradients", lambda: mmdit_gradient_phase(swaps))

    # F5TTS_Base: RoPE on the first head only, K3 and K6 (and K2/K5)
    with torch.inference_mode():
        runs["base_synthesis"] = phase("base synthesis", lambda: preset_synthesis_phase(
            "base synthesis", preset_tts("base synthesis", "F5TTS_Base"),
            expected_counts(partial_rope_attention=DEPTH * NFE, gated_adaln=DEPTH * NFE), runs=1))
    base = byte_model(preset("F5TTS_Base"))
    assert (base.arch.pe_attn_head, base.arch.text_mask_padding) == (1, False), base.arch
    runs["base_training_step"], _ = phase("base training", lambda: training_phase(
        "base training", base,
        expected_counts(partial_rope_attention=DEPTH, partial_rope_attention_bwd=DEPTH,
                        gated_adaln=DEPTH, gated_adaln_bwd=DEPTH),
        updates=2, warmup=1, checkpoints=False))

    # E2TTS_Base: a UNetT, attention on N+1 rows through K3 and K6, no AdaLN
    with torch.inference_mode():
        e2 = Serving("E2TTS_Base", E2_DEPTH, "e2 synthesis")
        runs["e2_synthesis"] = phase("e2 synthesis", lambda: synthesis_phase(
            "e2 synthesis", e2.infer, expected_counts(partial_rope_attention=E2_DEPTH * NFE),
            runs=3))
        runs["e2_captured_synthesis_capture"] = phase("e2 captured synthesis",
                                                      lambda: e2_captured_phase(e2))
        del e2
    e2_cfg = byte_model(preset("E2TTS_Base"))
    assert (e2_cfg.arch.depth, e2_cfg.arch.ff_mult, e2_cfg.arch.pe_attn_head) == (E2_DEPTH, 4, 1)
    runs["e2_training_step"], _ = phase("e2 training", lambda: training_phase(
        "e2 training", e2_cfg, expected_counts(partial_rope_attention=E2_DEPTH,
                                               partial_rope_attention_bwd=E2_DEPTH),
        updates=2, warmup=1, checkpoints=False))

    # the F5E model of configs/example.yaml: a PPG-conditioned, codebook-
    # regularised F5TTS_Small with remat "block"; K3 at 12 heads, K2/K5 at D = 768
    f5e = f5e_model_config()
    assert (f5e.arch.depth, f5e.arch.heads, f5e.arch.pe_attn_head) == (F5E_DEPTH, 12, 1)
    extractor = phase("ppg extraction", f5e_extractor_phase)
    # under remat "block" each block's forward kernels run again in the recompute
    runs["f5e_training_step"], _ = phase("f5e training", lambda: training_phase(
        "f5e training", f5e,
        expected_counts(partial_rope_attention=2 * F5E_DEPTH, partial_rope_attention_bwd=F5E_DEPTH,
                        gated_adaln=2 * F5E_DEPTH, gated_adaln_bwd=F5E_DEPTH),
        updates=4, warmup=1, resume=True, extractor=extractor))
    runs["f5e_training_step_no_remat"] = phase("f5e training, no remat",
                                               lambda: f5e_no_remat_phase(f5e, extractor))
    phase("f5e gradients", lambda: f5e_gradient_phase(swaps))
    with torch.inference_mode():
        runs.update(phase("f5e serving", lambda: f5e_serving_phase(extractor)))
    # the PPG front end's own life cycle: captured PPG engines, offline
    # extraction, ASR training, streaming, recognition (no kernel of the port)
    phase("ppg engines", lambda: ppg_engines_phase(extractor))
    phase("offline extraction", lambda: offline_extraction_phase(
        extractor, ROOT / "build" / "smoke" / "ppg_cli"))
    del extractor
    asr = phase("asr training", asr_training_phase)
    phase("streaming", lambda: streaming_phase(asr))
    phase("recognition", lambda: recognition_phase(asr))

    # serving on one v1 model: EPSS grid, captured engines, device decode,
    # streaming, the TTS sampler mode and speech editing
    with torch.inference_mode():
        sv = Serving()
        runs["epss_synthesis"] = phase("epss synthesis", lambda: epss_phase(sv))
        runs["captured_synthesis_capture"] = phase("captured synthesis",
                                                   lambda: captured_phase(sv))
        phase("device decode and streaming", lambda: decode_stream_phase(sv))
        runs["tts_mode_synthesis"] = phase("tts mode", lambda: tts_mode_phase(sv))
        runs["speech_edit"] = phase("speech edit", lambda: speech_edit_phase(sv))
        runs["derived_span_edit"] = phase("derived-span edit",
                                          lambda: derived_span_edit_phase(sv, asr))
        # the main entry point's options
        runs["sampler_options"] = phase("sampler options", lambda: sampler_options_phase(sv))
        runs["seeded_requests"] = phase("seeded requests", lambda: seeded_phase(sv))
        runs["int8_synthesis"] = phase("int8 synthesis", lambda: int8_phase(sv))
        runs["engine_dir_asr"] = phase("engine dir and asr model",
                                       lambda: engine_dir_asr_phase(sv))
        # the serving batcher on (b, 1536) engines, and the servers
        runs.update(phase("batched serving", lambda: batched_serving_phase(sv)))
        del sv
    del asr
    # the YAML training CLI on the F5E model with 8-bit AdamW
    runs["cli_f5e_step"] = phase("training cli", lambda: training_cli_phase(
        ROOT / "build" / "smoke" / "cli"))

    # which paths launched each kernel, and how often in one run of the path
    paths = {name: {p: c[name] for p, c in runs.items() if c[name]} for name in COUNTERS}
    missing = [name for name, by_path in paths.items() if not by_path]
    if missing:
        raise AssertionError(f"no path launched {missing}")
    rows = phase("attention kernels", lambda: attention_rows((ra, ka), paths, text_len, splits))
    with torch.inference_mode():
        rows.append(adaln_phase(ga, paths["gated_adaln"]))
    rows.append(adaln_bwd_phase(ga, paths["gated_adaln_bwd"], splits[2]))
    log(f"[total] {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
